"""The PyTorch package's LM ``Server`` and serving launcher against the
reference's, at the reduced configs, and the carrying of a reference
parameter tree across (bf16 included).

Parameters come from the reference's ``init`` and are carried across with
``engine.flat.params_from_numpy``; prompts come from numpy seeds. Greedy
tokens are compared exactly: the reduced configs run in fp32, where the two
packages' logits agree to about 6e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import MeshConfig as JMeshConfig
from repro.core.distributed import Server as JServer
from repro.models import transformer as JT
from repro.utils.compat import make_mesh, set_mesh
from repro_torch import configs
from repro_torch.config import MeshConfig
from repro_torch.core.distributed import Server
from repro_torch.engine.flat import params_from_numpy
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_mesh_from_config, make_production_mesh
from repro_torch.models import build
from repro_torch.models import transformer as T
from repro_torch.sharding import DeviceMesh
from repro_torch.utils.pytree import tree_flatten
from test_torch_threads import one_torch_thread  # noqa: F401


def _cfgs(arch, **kw):
    return (jconfigs.reduced(jconfigs.get_config(arch)).with_(**kw),
            configs.reduced(configs.get_config(arch)).with_(**kw))


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


# ---------------------------------------------------------------------------
# the Server and the launcher
# ---------------------------------------------------------------------------


def _greedy(prefill, decode, params, toks, cache, n, as_tok):
    logits, cache = prefill(params, {"tokens": as_tok(toks)}, cache)
    out = []
    for _ in range(n):
        tok = np.asarray(logits[:, -1:].argmax(-1))
        out.append(tok)
        logits, cache = decode(params, as_tok(tok), cache)
    return np.concatenate(out, axis=1)


def test_server_greedy_tokens_equal_reference():
    jcfg, cfg = _cfgs("tinyllama-1.1b", use_flash=True, n_kv_heads=2)
    B, S, n = 3, 128, 4
    toks = _tokens(cfg, B, S, seed=11).astype(np.int32)
    mesh = make_mesh((1, 1), ("data", "model"))
    jserver = JServer(jcfg, JMeshConfig(data=1, model=1), mesh=mesh)
    with set_mesh(mesh):
        jp = jserver.shard_params(jserver.model.init(jax.random.key(0)))
        jcache = jserver.shard_cache(jserver.model.init_cache(B, S + n + 8))
        batch_t = {"tokens": jax.ShapeDtypeStruct(toks.shape, toks.dtype)}
        jprefill = jserver.jit_prefill(jax.eval_shape(lambda: jp), batch_t,
                                       jax.eval_shape(lambda: jcache))
        jdecode = jserver.jit_decode(jax.eval_shape(lambda: jp),
                                     jax.eval_shape(lambda: jcache))
        want = _greedy(jprefill, jdecode, jp, toks, jcache, n,
                       lambda a: jnp.asarray(a, jnp.int32))

    server = Server(cfg, MeshConfig(data=1, model=1), device="cpu")
    tp = server.shard_params(params_from_numpy(jax.tree.map(np.asarray, jp),
                                               "cpu"))
    tcache = server.shard_cache(server.model.init_cache(B, S + n + 8, "cpu"))
    got = _greedy(server.prefill, server.decode, tp, toks, tcache, n,
                  lambda a: torch.as_tensor(a, dtype=torch.long))
    np.testing.assert_array_equal(got, want)


def test_serve_launcher_runs_on_cpu(capsys):
    out = serve.main(["--arch", "tinyllama-1.1b", "--batch", "2",
                      "--prompt-len", "128", "--new-tokens", "4",
                      "--device", "cpu", "--seed", "3"])
    assert out["tokens"].shape == (2, 4) and out["arch"] == "tinyllama-1.1b"
    assert ((0 <= out["tokens"]) & (out["tokens"] < 512)).all()
    assert "[serve] arch=tinyllama-1.1b device=cpu" in capsys.readouterr().out
    again = serve.main(["--batch", "2", "--prompt-len", "128",
                        "--new-tokens", "4", "--device", "cpu", "--seed", "3"])
    np.testing.assert_array_equal(again["tokens"], out["tokens"])
    assert flash_attention.launches == 0


def test_meshes_and_other_families_raise():
    """A mesh that names one device many times serves as that device does:
    ``Server`` on a 2 x 2 mesh naming the CPU and the launcher with
    ``--devices 4`` give the one-device tokens bit for bit (flash on, set
    through ``--set``). A mesh of distinct devices raises, naming A12b."""
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b")).with_(
        use_flash=True)
    B, S, n, seed = 2, 128, 4, 3
    as_tok = lambda a: torch.as_tensor(a, dtype=torch.long)   # noqa: E731
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))
    one = Server(cfg, device="cpu")
    params = one.model.init(torch.Generator().manual_seed(seed), "cpu")
    want = _greedy(one.prefill, one.decode, params, toks,
                   one.model.init_cache(B, S + n + 8, "cpu"), n, as_tok)

    mesh = make_production_mesh(device="cpu")
    assert mesh.size == 256 and set(mesh.devices) == {torch.device("cpu")}
    mesh = make_mesh_from_config(MeshConfig(data=2, model=2), "cpu")
    server = Server(cfg, MeshConfig(data=2, model=2), mesh=mesh)
    assert server.device == torch.device("cpu") and server.mesh == mesh
    p = server.shard_params(params)
    cache = server.shard_cache(server.model.init_cache(B, S + n + 8, "cpu"))
    got = _greedy(server.jit_prefill(p, {"tokens": toks}, cache),
                  server.jit_decode(p, cache), p, toks, cache, n, as_tok)
    np.testing.assert_array_equal(got, want)
    out = serve.main(["--devices", "4", "--device", "cpu", "--batch",
                      str(B), "--prompt-len", str(S), "--new-tokens", str(n),
                      "--seed", str(seed), "--set", "use_flash=true"])
    assert out["devices"] == 4
    np.testing.assert_array_equal(out["tokens"], want)

    distinct = DeviceMesh(("cpu", "meta"), ("data", "model"), (2, 1))
    with pytest.raises(NotImplementedError, match="A12b"):
        Server(cfg, MeshConfig(data=2, model=1), mesh=distinct)
    with pytest.raises(ValueError, match="MeshConfig"):
        Server(cfg, MeshConfig(data=2, model=1), mesh=mesh)
    with pytest.raises(SystemExit):
        serve.main(["--devices", "3", "--device", "cpu"])
    with pytest.raises(ValueError, match="unknown family"):
        build(cfg.with_(family="rnn"))
    with pytest.raises(NotImplementedError):
        build(configs.get_config("paper-cnn")).init_cache(1, 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Server(cfg)


# ---------------------------------------------------------------------------
# carrying a reference tree across
# ---------------------------------------------------------------------------


def test_bf16_stacked_tree_carries_bit_for_bit():
    jcfg = jconfigs.reduced(jconfigs.get_config("tinyllama-1.1b")).with_(
        param_dtype="bfloat16")
    jp = JT.init(jax.random.key(7), jcfg)
    host = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(host, "cpu")
    jleaves, _ = jax.tree_util.tree_flatten_with_path(host)
    assert sorted(tp) == ["embed", "final_norm", "layers", "lm_head"]
    for path, a in jleaves:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))
    assert tp["layers"]["attn"]["wq"].shape[0] == jcfg.n_layers
    # the port's own init has the same tree, shapes and dtypes
    mine = T.init(torch.Generator().manual_seed(0),
                  configs.reduced(configs.get_config("tinyllama-1.1b")).with_(
                      param_dtype="bfloat16"), "cpu")
    leaves, treedef = tree_flatten(mine)
    assert treedef == tree_flatten(tp)[1]
    assert [tuple(t.shape) for t in leaves] == [a.shape for _, a in jleaves]
    assert all(t.dtype == torch.bfloat16 for t in leaves)
