"""The PyTorch package's dry run (``launch/dryrun.py``) against the
reference's (``src/repro/launch/dryrun.py``).

Three tiers, all exact:

* **Against XLA at a small mesh.** One subprocess with eight forced host
  devices compiles the reference on a 4 x 2 ``data`` x ``model`` mesh, as
  ``tests/test_distributed.py`` does: the train steps of the reduced
  TinyLlama (batch ``(4, 1, 2, 32)``, SGD) under every strategy, in fp32,
  with bf16 parameters and with a bf16 aggregation; the ``local`` steps of
  the reduced qwen3-moe, RWKV-6, Hymba, Whisper and LLaVA (the last two
  with their ``frames`` and ``image_embeds``), and of each with ``remat``
  on (``MODEL_CASES``); and a prefill (B 8, S 64) and a decode of six
  families. The port's
  reckoning at ``MeshConfig(data=4, model=2)`` must give XLA's per-device
  argument bytes (less the leaves that ``jax.jit`` drops because the step
  does not read them, each named in ``UNUSED``), its output bytes, and
  every step's collective bytes and counts by kind: the strategy's (XLA's
  less the ``local`` step's) and the whole figure, the model's
  tensor-parallel and routing collectives and the remat term included. A
  bf16 aggregation, and a bf16 model's activations, are reduced in bf16 in
  the lowered program, but XLA's CPU backend widens every all-reduce to
  fp32; the tests check both facts and hold the port's 2 bytes an element
  to XLA's 4.
* **Against the reference's specs at the production meshes.** For every
  arch of ``configs.ASSIGNED``, every shape and both meshes, the port's
  argument bytes equal the same sum over the reference's ``jax.eval_shape``
  templates under the reference's specs, part by part; the micro-batching,
  window, participant count and the roofline's FLOP and byte terms equal
  the reference's.
* **The command line.** ``main`` writes its records, skips them on a
  second call without ``--force``, and its process imports neither ``jax``
  nor ``repro`` and sets no environment variable.
"""

import functools
import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro import roofline as jroof
from repro.config import SHAPES as JSHAPES
from repro.config import MeshConfig as JMeshConfig
from repro.config import TrainConfig as JTrainConfig
from repro.core.distributed import DistributedTrainer as JTrainer
from repro.core.distributed import Server as JServer
from repro.sharding import ShardingPolicy as JPolicy
from repro.sharding import input_specs as j_input_specs
from repro_torch import configs
from repro_torch.config import H100, SHAPES, MeshConfig, ShapeConfig
from repro_torch.launch import dryrun
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(REPO, "src")

SMALL_MESH = MeshConfig(data=4, model=2)
TRAIN_SHAPE = ShapeConfig("train_small", 32, 8, "train")     # (4, 1, 2, 32)
SERVE_SHAPES = {"prefill": ShapeConfig("prefill_small", 64, 8, "prefill"),
                "decode": ShapeConfig("decode_small", 64, 8, "decode")}
SERVE_ARCHS = ["tinyllama-1.1b", "qwen3-moe-30b-a3b", "rwkv6-1.6b",
               "hymba-1.5b", "whisper-large-v3", "llava-next-mistral-7b"]
STRATEGIES = ["modest", "fedavg", "dsgd", "local"]
# (param_dtype, agg_dtype, strategy) of the train steps compiled
TRAIN_CASES = ([("float32", "float32", s) for s in STRATEGIES]
               + [("bfloat16", "float32", s) for s in ("modest", "dsgd",
                                                      "local")]
               + [("float32", "bfloat16", "modest")])
# (arch, remat) of the fp32 ``local`` steps compiled besides TRAIN_CASES
MODEL_CASES = [("qwen3-moe-30b-a3b", False), ("tinyllama-1.1b", True),
               ("qwen3-moe-30b-a3b", True), ("rwkv6-1.6b", False),
               ("rwkv6-1.6b", True), ("hymba-1.5b", False),
               ("hymba-1.5b", True), ("whisper-large-v3", False),
               ("whisper-large-v3", True), ("llava-next-mistral-7b", False),
               ("llava-next-mistral-7b", True)]
# leaves that jax.jit drops from the compiled step's arguments because the
# step does not read them: a dense, MoE, Hymba, Whisper or LLaVA prefill
# writes the cache's position and never reads it (RWKV's prefill adds to
# it), and Whisper's writes its whole cross cache; Whisper's decode reads
# the cross keys and values from the cache, so neither the encoder nor the
# cross-attention's key and value projections
_WHISPER_ENCODER = ["params/enc_pos", "params/enc_norm/bias",
                    "params/enc_norm/scale"] + [
    f"params/encoder/{w}" for w in (
        "attn/wk", "attn/wo", "attn/wq", "attn/wv", "ln1/bias", "ln1/scale",
        "ln2/bias", "ln2/scale", "mlp/wi", "mlp/wo")]
UNUSED = {("prefill", "tinyllama-1.1b"): ["cache/pos"],
          ("prefill", "qwen3-moe-30b-a3b"): ["cache/pos"],
          ("prefill", "hymba-1.5b"): ["cache/pos"],
          ("prefill", "whisper-large-v3"): ["cache/pos", "cache/xk",
                                            "cache/xv"],
          ("decode", "whisper-large-v3"): _WHISPER_ENCODER + [
              "params/decoder/xattn/wk", "params/decoder/xattn/wv"],
          ("prefill", "llava-next-mistral-7b"): ["cache/pos"]}


def _xla_script() -> str:
    return textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import json, re
        import jax, jax.numpy as jnp
        from repro import configs
        from repro.config import MeshConfig, ShapeConfig, TrainConfig
        from repro.core.distributed import DistributedTrainer, Server
        from repro.sharding import input_specs
        from repro.utils.compat import make_mesh, set_mesh
        from repro.utils.hlo import collective_bytes

        mesh = make_mesh((4, 2), ("data", "model"))
        mcfg = MeshConfig(data=4, model=2)

        def rec(compiled):
            m = compiled.memory_analysis()
            return {{"argument": int(m.argument_size_in_bytes),
                    "output": int(m.output_size_in_bytes),
                    "collectives": collective_bytes(compiled.as_text())}}

        out = {{}}
        with set_mesh(mesh):
            for pdt, adt, strategy in {TRAIN_CASES!r}:
                cfg = configs.reduced(configs.get_config("tinyllama-1.1b"))
                cfg = cfg.with_(param_dtype=pdt)
                tr = DistributedTrainer(
                    cfg, TrainConfig(optimizer="sgd", agg_dtype=adt), mcfg,
                    strategy=strategy, mesh=mesh)
                P = tr.policy.n_participants
                st = tr.abstract_state()
                b = {{k: jax.ShapeDtypeStruct((P, 1, 2, 32), jnp.int32)
                     for k in ("tokens", "labels")}}
                w = jax.ShapeDtypeStruct((P,), jnp.float32)
                lowered = tr.jit_train_step(st, b).lower(st, b, w)
                compiled = lowered.compile()
                r = rec(compiled)
                # the weights cast to the aggregation's dtype in the program
                # as lowered, and the dtypes of the compiled all-reduces
                r["weights_in_program"] = [
                    t for t in ("4xbf16", "4xf32")
                    if f"tensor<{{t}}>" in lowered.as_text()]
                r["all_reduce_dtypes"] = sorted({{
                    ln.split("=", 1)[1].split("[", 1)[0].strip(" (")
                    for ln in compiled.as_text().splitlines()
                    if " all-reduce(" in ln}})
                # the dtypes of the products whose outputs are the
                # activations (P, B, S, d) in the program as lowered
                r["activation_dots"] = sorted({{
                    t for ln in lowered.as_text().splitlines()
                    if "dot_general" in ln
                    for t in re.findall(r"-> tensor<4x2x32x256x(\\w+)>", ln)}})
                out[f"train/{{pdt}}/{{adt}}/{{strategy}}"] = r
            for arch, remat in {MODEL_CASES!r}:
                cfg = configs.reduced(configs.get_config(arch)).with_(
                    remat=remat)
                tr = DistributedTrainer(
                    cfg, TrainConfig(optimizer="sgd"), mcfg,
                    strategy="local", mesh=mesh)
                st = tr.abstract_state()
                b = {{k: jax.ShapeDtypeStruct((4, 1, 2, 32), jnp.int32)
                     for k in ("tokens", "labels")}}
                # the frontend's input, as dryrun._train_batch_template
                # shapes it
                front = {{"audio": ("frames", cfg.n_frames),
                         "vlm": ("image_embeds",
                                 cfg.image_tokens * cfg.anyres_tiles)}}
                if cfg.family in front:
                    key, n = front[cfg.family]
                    b[key] = jax.ShapeDtypeStruct(
                        (4, 1, 2, n, cfg.d_model), jnp.dtype(cfg.param_dtype))
                w = jax.ShapeDtypeStruct((4,), jnp.float32)
                out[f"model/{{arch}}/{{remat}}"] = rec(
                    tr.jit_train_step(st, b).lower(st, b, w).compile())
            for arch in {SERVE_ARCHS!r}:
                cfg = configs.reduced(configs.get_config(arch))
                srv = Server(cfg, mcfg, mesh=mesh)
                pt = jax.eval_shape(srv.model.init, jax.random.key(0))
                ct = srv.abstract_cache(8, 64 + (
                    cfg.image_tokens * cfg.anyres_tiles
                    if cfg.family == "vlm" else 0))
                bt = input_specs(cfg, ShapeConfig("p", 64, 8, "prefill"),
                                 srv.policy)
                out[f"prefill/{{arch}}"] = rec(
                    srv.jit_prefill(pt, bt, ct).lower(pt, bt, ct).compile())
                tok = jax.ShapeDtypeStruct((8, 1), jnp.int32)
                out[f"decode/{{arch}}"] = rec(
                    srv.jit_decode(pt, ct).lower(pt, tok, ct).compile())
        print("XLA " + json.dumps(out))
    """)


@pytest.fixture(scope="module")
def xla():
    proc = subprocess.run([sys.executable, "-c", _xla_script()],
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": SRC})
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("XLA "))
    return json.loads(line[4:])


def _train(pdt, adt, strategy):
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b")).with_(
        param_dtype=pdt)
    return dryrun.reckon(cfg, TRAIN_SHAPE, SMALL_MESH, strategy=strategy,
                         agg_dtype=adt)


def _model_case(arch, remat):
    """The fp32 ``local`` step of a ``MODEL_CASES`` entry, with XLA's batch
    of one micro step of two sequences a participant."""
    cfg = configs.reduced(configs.get_config(arch)).with_(remat=remat)
    return dryrun.reckon(cfg, TRAIN_SHAPE, SMALL_MESH, strategy="local",
                         micro_override=1)


def _model_list(cfg, kind="train"):
    """The model's collectives as :func:`dryrun.model_collectives` lists
    them for ``cfg`` at the small mesh."""
    shape = TRAIN_SHAPE if kind == "train" else SERVE_SHAPES[kind]
    parts = dryrun.step_parts(cfg, shape, SMALL_MESH, strategy="local",
                              micro_override=1)
    tree, spec = parts["arguments"]["params"]
    if kind == "train":
        treedef = dryrun.tree_flatten(tree)[1]
        spec = treedef.unflatten([s[1:] for s in
                                  treedef.flatten_up_to(spec)])
        return dryrun.model_collectives(cfg, shape, parts["policy"], spec,
                                        micro=1, b_micro=2)[0]
    return dryrun.model_collectives(cfg, shape, parts["policy"], spec)[0]


def _serve(kind, arch):
    cfg = configs.reduced(configs.get_config(arch))
    return dryrun.reckon(cfg, SERVE_SHAPES[kind], SMALL_MESH)


def _unused_bytes(kind, arch) -> int:
    """The bytes of the leaves named in ``UNUSED`` for this step, each
    found among the step's argument leaves."""
    names = UNUSED.get((kind, arch), [])
    if not names:
        return 0
    cfg = configs.reduced(configs.get_config(arch))
    parts = dryrun.step_parts(cfg, SERVE_SHAPES[kind], SMALL_MESH)
    found = {}
    for part, (tree, specs) in parts["arguments"].items():
        for path, n in dryrun.leaf_bytes(tree, specs,
                                         parts["policy"]).items():
            found[f"{part}/{path}"] = n
    assert set(names) <= set(found), sorted(found)
    return sum(found[n] for n in names)


# ---------------------------------------------------------------------------
# against XLA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", TRAIN_CASES, ids="/".join)
def test_train_step_bytes_equal_xla(xla, case):
    """Argument and output bytes a device, exactly; the arguments split
    into their parts (SGD keeps no optimizer state, the strategies no
    server state)."""
    got, want = _train(*case), xla["train/" + "/".join(case)]
    mem = got["memory"]
    assert mem["argument_size_in_bytes"] == want["argument"]
    assert mem["output_size_in_bytes"] == want["output"]
    assert sum(mem["by_part"].values()) == mem["argument_size_in_bytes"]
    assert mem["by_part"]["optimizer_state"] == 0
    assert mem["by_part"]["weights"] == 4       # (P,) fp32 over data = 4
    assert mem["reckoned"] is True
    assert "temp_size_in_bytes" not in mem


@pytest.mark.parametrize("case", [c for c in TRAIN_CASES if c[2] != "local"],
                         ids="/".join)
def test_strategy_collectives_equal_xla(xla, case):
    """The strategy's own collectives are XLA's less the ``local`` step's
    (same parameter dtype), by kind, bytes and count."""
    pdt, adt, strategy = case
    rec = _train(*case)["collectives"]
    got = rec["strategy"]
    xrec = xla["train/" + "/".join(case)]
    want = xrec["collectives"]
    base = xla[f"train/{pdt}/float32/local"]["collectives"]
    diff = {key: {k: v - base[key].get(k, 0) for k, v in want[key].items()
                  if v - base[key].get(k, 0)} for key in ("bytes", "counts")}
    if adt == "bfloat16":
        # The program reduces in bf16 (its weights are cast to bf16), but
        # XLA's CPU backend widens every all-reduce to fp32, so the
        # compiled figure carries the mean at 4 bytes a lane. The port
        # reckons the program's wire: 2 bytes a lane, plus the fp32 sum.
        assert "4xbf16" in xrec["weights_in_program"]
        assert xrec["all_reduce_dtypes"] == ["f32"]
        lanes = (diff["bytes"]["all-reduce"] - 4) // 4
        diff["bytes"]["all-reduce"] = lanes * 2 + 4
    assert got["bytes"] == diff["bytes"]
    assert got["counts"] == diff["counts"]
    assert rec["total_bytes"] == rec["per_device_bytes"] * 8
    assert "not reckoned" not in rec["reckoned"]


def test_local_step_reckons_no_collective_where_xla_has_tensor_parallel_ones(
        xla):
    """The ``local`` step has no strategy collective, and its model
    collectives are XLA's 13 all-reduces, 1,049,352 bytes a device: per
    layer the attention's and the MLP's row-parallel outputs forward, the
    q/k/v and g/u input gradients backward (one op each, 3 and 2
    operands); the vocab-parallel embedding, the loss's max, sum and
    target logit (with ``h``'s gradient); the metrics over ``data``."""
    got = _train("float32", "float32", "local")["collectives"]
    assert got["strategy"] == {"bytes": {}, "counts": {}}
    assert got["bytes"] == {"all-reduce": 1_049_352}
    assert got["counts"] == {"all-reduce": 13}
    assert got["total_bytes"] == 8 * 1_049_352
    assert xla["train/float32/float32/local"]["collectives"]["bytes"] == {
        "all-reduce": 1_049_352}
    assert xla["train/float32/float32/local"]["collectives"]["counts"] == {
        "all-reduce": 13}
    assert got["remat"] == {"bytes": {}, "counts": {}}


@pytest.mark.parametrize("case", TRAIN_CASES, ids="/".join)
def test_train_step_collectives_equal_xla(xla, case):
    """The whole step, strategy and model together, is XLA's figure by
    kind, bytes and count. With bf16 parameters the activations' products
    are bf16 in the program as lowered and every compiled all-reduce is
    fp32 (XLA's CPU backend widens them): the port reckons the program's
    2 bytes an element, held here at XLA's 4."""
    pdt, adt, strategy = case
    rec = _train(*case)["collectives"]
    xrec = xla["train/" + "/".join(case)]
    want = xrec["collectives"]
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b")).with_(
        param_dtype=pdt)
    model = _model_list(cfg)
    assert dryrun.summarize(model) == rec["model"]
    wide = dryrun.summarize(model, widen=True)
    strat = dict(rec["strategy"]["bytes"])
    if adt == "bfloat16":
        strat["all-reduce"] = (strat["all-reduce"] - 4) * 2 + 4
    got = {k: wide["bytes"].get(k, 0) + strat.get(k, 0)
           for k in set(wide["bytes"]) | set(strat)}
    assert got == want["bytes"]
    assert rec["counts"] == want["counts"]
    assert rec["per_device_bytes"] == sum(rec["bytes"].values())
    assert xrec["activation_dots"] == [{"float32": "f32",
                                        "bfloat16": "bf16"}[pdt]]
    if pdt == "bfloat16":
        assert xrec["all_reduce_dtypes"] == ["f32"]
        assert rec["bytes"]["all-reduce"] < want["bytes"]["all-reduce"]
        assert {dt for c in model for _, dt in c.operands} == {
            "bfloat16", "float32"}
    elif adt == "float32":
        assert rec["bytes"] == want["bytes"]


@pytest.mark.parametrize("arch,remat", MODEL_CASES,
                         ids=[f"{a}/remat={r}" for a, r in MODEL_CASES])
def test_model_collectives_equal_xla(xla, arch, remat):
    """The reduced qwen3-moe's ``local`` step (experts over ``model``: the
    router's softmax and top k, the slot positions, the combine, their
    gradients and the router's gradient gathered), RWKV-6's (the residual
    stream split over d: the norms' sums, the mixed inputs gathered, the
    replicated leaves' gradients gathered) and Hymba's (``in_proj``'s
    halves permuted, the scan's B and C gradients summed at every step),
    and each with ``remat``: every kind's bytes and count exactly. The
    remat term is what XLA's backward recomputes (the attention's output;
    the MoE's router collectives, not its combine; RWKV-6's seven forward
    all-reduces, not its gathers; Hymba's permutes and two all-reduces),
    and equals XLA's remat step less its plain one."""
    got = _model_case(arch, remat)["collectives"]
    want = xla[f"model/{arch}/{remat}"]["collectives"]
    assert got["bytes"] == want["bytes"]
    assert got["counts"] == want["counts"]
    if remat:
        plain = (xla["train/float32/float32/local"] if arch ==
                 "tinyllama-1.1b" else xla[f"model/{arch}/False"])
        plain = plain["collectives"]
        for key in ("bytes", "counts"):
            assert got["remat"][key] == {
                k: v - plain[key].get(k, 0) for k, v in want[key].items()
                if v != plain[key].get(k, 0)}
    else:
        assert got["remat"] == {"bytes": {}, "counts": {}}
    if arch in ("qwen3-moe-30b-a3b", "rwkv6-1.6b"):
        assert set(got["bytes"]) == {"all-reduce", "all-gather"}
    if arch == "hymba-1.5b":
        assert set(got["bytes"]) == {"all-reduce", "collective-permute"}
    assert "not reckoned" not in got["reckoned"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_step_bytes_equal_xla(xla, arch, kind):
    """Argument bytes exactly, less the named unused leaves (whose bytes
    are exactly the gap); output bytes (logits, cache, tuple index)
    exactly; the collectives XLA's (the dense row-parallel outputs and
    embedding; the MoE's top k gathered over ``data``, slot positions,
    combine and, for a decode, whose tokens split the group over ``data``,
    the priorities' gather and the dispatch's all-reduce; RWKV-6's norms,
    gathers and row-parallel sums over a residual split over d, with a
    decode's embedding resharded over ``data``; Hymba's ``in_proj``
    permutes and row-parallel sums)."""
    got, want = _serve(kind, arch), xla[f"{kind}/{arch}"]
    mem = got["memory"]
    assert mem["argument_size_in_bytes"] - _unused_bytes(kind, arch) == \
        want["argument"]
    assert mem["output_size_in_bytes"] == want["output"]
    assert set(mem["by_part"]) == {"params", "batch", "cache"}
    coll = got["collectives"]
    assert coll["bytes"] == want["collectives"]["bytes"]
    assert coll["counts"] == want["collectives"]["counts"]
    assert coll["bytes"]
    assert "not reckoned" not in coll["reckoned"]
    assert coll["strategy"] == {"bytes": {}, "counts": {}}


def test_unused_leaves_are_dropped_only_where_named(xla):
    """Where no leaf is named the port's bytes equal XLA's without excuse;
    a named cache position is its 4-byte scalar, and only Whisper's steps
    name whole tensors (its prefill's cross cache, its decode's encoder
    and cross key and value projections), each gap exactly the named
    leaves' bytes."""
    for arch in SERVE_ARCHS:
        for kind in ("prefill", "decode"):
            gap = (_serve(kind, arch)["memory"]["argument_size_in_bytes"]
                   - xla[f"{kind}/{arch}"]["argument"])
            names = UNUSED.get((kind, arch), [])
            assert gap == _unused_bytes(kind, arch), (arch, kind)
            if arch != "whisper-large-v3":
                assert gap == 4 * len(names) and set(names) <= {
                    "cache/pos"}, (arch, kind)


# ---------------------------------------------------------------------------
# against the reference's specs at the production meshes
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jdryrun():
    """The reference's dry-run module. Importing it appends a forced
    device count to ``XLA_FLAGS`` for the process it expects to own; the
    variable is put back at once (no backend is initialised on import), so
    this test process keeps its one device."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jd
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jd


def _jbytes(tree, specs, policy) -> int:
    """Bytes a device of a reference tree under its specs."""
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        n = math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize
        split = math.prod(policy._axes_size(a) for a in spec)
        assert n % split == 0
        total += n // split
    return total


@functools.lru_cache(maxsize=None)
def _jparams(jcfg):
    from repro.models import build as jbuild
    return jax.eval_shape(jbuild(jcfg).init, jax.random.key(0))


def _reference_parts(arch, shape_name, multi_pod) -> dict:
    """The reference dry run's templates and specs, by part, as its
    ``dryrun_one`` builds them (no compile)."""
    jd = _jdryrun()
    shape = JSHAPES[shape_name]
    jcfg = jd.effective_config(arch, shape_name)
    mcfg = JMeshConfig(multi_pod=multi_pod)
    pol = JPolicy(jcfg, mcfg)
    if shape.kind == "train":
        micro, b_micro = jd._micro_batch(arch, shape, pol.n_participants)
        tr = JTrainer(jcfg, JTrainConfig(optimizer="sgd"), mcfg)
        st = tr.abstract_state()
        spec = tr.state_spec(st)
        batch = jd._train_batch_template(jcfg, shape, pol, micro, b_micro)
        weights = jax.ShapeDtypeStruct((pol.n_participants,), jnp.float32)
        parts = {
            "params": (st.params, spec.params),
            "optimizer_state": (st.opt_state, spec.opt_state),
            "strategy_state": (st.server_state, spec.server_state),
            "round": (st.round, spec.round),
            "batch": (batch, pol.batch_spec(batch, with_participants=True)),
            "weights": (weights, pol.weights_spec()),
        }
        return {"policy": pol, "cfg": jcfg, "micro": (micro, b_micro),
                "parts": parts}
    shard_seq = shape.name == "long_500k"
    srv = JServer(jcfg, mcfg, shard_seq=shard_seq)
    params = _jparams(jcfg)
    cache = srv.abstract_cache(shape.global_batch, jd._cache_len(jcfg, shape))
    pspec, cspec = srv.specs(params, cache)
    if shape.kind == "prefill":
        batch = j_input_specs(jcfg, shape, pol)
        bspec = pol.batch_spec(batch, with_participants=False,
                               shard_seq=shard_seq)
    else:
        batch = jax.ShapeDtypeStruct((shape.global_batch, 1), jnp.int32)
        # the token's spec, as the reference's jit_decode builds it
        bspec = jax.sharding.PartitionSpec(*pol._fix_divisibility(
            (None if shard_seq else "data", None), (shape.global_batch, 1)))
    parts = {"params": (params, pspec), "batch": (batch, bspec),
             "cache": (cache, cspec)}
    return {"policy": pol, "cfg": jcfg, "micro": None, "parts": parts}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", configs.ASSIGNED)
def test_production_argument_bytes_equal_reference_specs(arch, multi_pod):
    """Every shape: the argument bytes a device, part by part, and the
    record's micro-batching, window, participants and roofline terms."""
    jd = _jdryrun()
    for shape_name in SHAPES:
        rec = dryrun.dryrun_one(arch, shape_name, multi_pod=multi_pod,
                                verbose=False)
        ref = _reference_parts(arch, shape_name, multi_pod)
        pol = ref["policy"]
        want = {k: _jbytes(t, s, pol) for k, (t, s) in ref["parts"].items()}
        assert rec["memory"]["by_part"] == want, shape_name
        assert rec["memory"]["argument_size_in_bytes"] == sum(want.values())
        assert rec["participants"] == pol.n_participants
        assert rec["window"] == ref["cfg"].window
        assert rec["window"] == jd.effective_config(arch, shape_name).window
        if ref["micro"]:
            assert (rec["micro_steps"], rec["micro_batch"]) == ref["micro"]
        chips = JMeshConfig(multi_pod=multi_pod).n_devices
        jterms = jroof.analytic_terms(
            ref["cfg"], JSHAPES[shape_name],
            n_participants=pol.n_participants,
            local_steps=ref["micro"][0] if ref["micro"] else 1,
            collective_total_bytes=rec["collectives"]["total_bytes"],
            chips=chips)
        for key in ("params", "param_bytes", "flops", "model_flops",
                    "useful_flop_ratio", "hbm_bytes"):
            assert rec["roofline"][key] == jterms[key], (shape_name, key)
        assert rec["roofline"]["raw_hlo_flops"] is None
        assert rec["roofline"]["raw_hlo_bytes"] is None


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_records_reckon_dense_and_moe_and_flag_the_rest(
        multi_pod):
    """At the production meshes every family's record carries its model
    collectives (the remat term in a train step) and the roofline's
    collective term reads the whole figure; Hymba, Whisper and LLaVA, the
    families whose heads ``model = 16`` does not divide (25 query heads;
    20; 8 kv heads), also keep the head-resharding note; no record says
    that tensor-parallel collectives are not reckoned, and the FSDP archs
    (``pod`` granularity) say that theirs are not."""
    note = "head resharding where the model axis splits a head not reckoned"
    for arch in configs.ASSIGNED:
        cfg = configs.get_config(arch)
        for shape_name in ("train_4k", "decode_32k"):
            rec = dryrun.dryrun_one(arch, shape_name, multi_pod=multi_pod,
                                    verbose=False)
            coll = rec["collectives"]
            assert coll["per_device_bytes"] == sum(coll["bytes"].values())
            chips = MeshConfig(multi_pod=multi_pod).n_devices
            assert rec["roofline"]["collective_s"] == \
                coll["total_bytes"] / (chips * H100.ici_bandwidth)
            assert "tensor-parallel collectives not reckoned" not in \
                coll["reckoned"]
            if cfg.participant_granularity == "pod":
                assert "FSDP collectives not reckoned" in coll["reckoned"]
                continue
            assert "tensor-parallel" not in coll["reckoned"]
            assert coll["model"]["bytes"]["all-reduce"] > 0
            if shape_name == "train_4k":
                assert coll["remat"]["bytes"]["all-reduce"] > 0
            assert (note in coll["reckoned"]) == bool(
                cfg.n_heads % 16 or cfg.n_kv_heads % 16), arch
            if cfg.family in ("ssm", "hybrid", "audio", "vlm"):
                assert (note in coll["reckoned"]) == (
                    cfg.family in ("hybrid", "audio", "vlm"))


def test_train_micro_window_and_artifact_names_equal_reference():
    jd = _jdryrun()
    assert dryrun.TRAIN_MICRO == jd.TRAIN_MICRO
    assert dryrun.LONG_CTX_WINDOW == jd.LONG_CTX_WINDOW
    for arch in configs.ASSIGNED:
        for name in SHAPES:
            assert dryrun.effective_config(arch, name).window == \
                jd.effective_config(arch, name).window
            for P in (1, 2, 16, 32, 512):
                for micro in (None, 3):
                    assert dryrun._micro_batch(arch, SHAPES[name], P, micro) \
                        == jd._micro_batch(arch, JSHAPES[name], P, micro)
    for args in (("tinyllama-1.1b", "train_4k", False),
                 ("gemma2-27b", "long_500k", True, "dsgd", "bf16")):
        assert os.path.basename(dryrun.artifact_path(*args)) == \
            os.path.basename(jd.artifact_path(*args))
    assert os.path.relpath(dryrun.ARTIFACT_DIR, REPO) == os.path.join(
        "build", "dryrun")


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


KEYS = {"arch", "shape", "mesh", "strategy", "participants", "window",
        "overrides", "memory", "collectives", "roofline", "reckon_s"}


def test_all_both_meshes_writes_eighty_complete_records(tmp_path,
                                                        monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    written = dryrun.main(["--all", "--both-meshes"])
    assert len(written) == 80 == len(os.listdir(tmp_path))
    for path in written:
        with open(path) as fh:
            rec = json.load(fh)
        assert KEYS <= set(rec), path
        mem = rec["memory"]
        assert mem["argument_size_in_bytes"] > 0
        assert mem["argument_size_in_bytes"] == sum(mem["by_part"].values())
        assert mem["output_size_in_bytes"] == sum(
            mem["output_by_part"].values())
        if rec["shape"] == "train_4k":
            assert {"micro_steps", "micro_batch", "accumulate"} <= set(rec)
    assert "all dry-runs OK (80 written)" in capsys.readouterr().out


def test_cli_writes_then_skips_and_imports_no_jax(tmp_path):
    out_dir = str(tmp_path / "records")
    code = textwrap.dedent(f"""
        import os, sys
        env = dict(os.environ)
        import repro_torch.launch.dryrun as d
        d.ARTIFACT_DIR = {out_dir!r}
        argv = ["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                "--both-meshes"]
        print("FIRST", len(d.main(argv)))
        print("SECOND", len(d.main(argv)))
        print("FORCED", len(d.main(argv + ["--force"])))
        print("BAD", sorted(m for m in sys.modules if m in ("jax", "jaxlib",
              "repro") or m.startswith(("jax.", "repro."))))
        print("ENV", dict(os.environ) == env)
    """)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env={**env, "PYTHONPATH": SRC})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    for line in ("FIRST 2", "SECOND 0", "FORCED 2", "BAD []", "ENV True"):
        assert line in out.splitlines(), out
    assert out.count("[dryrun] skip existing") == 2
    assert sorted(os.listdir(out_dir)) == [
        "tinyllama-1.1b__decode_32k__16x16__modest.json",
        "tinyllama-1.1b__decode_32k__2x16x16__modest.json"]
    with open(os.path.join(out_dir, sorted(os.listdir(out_dir))[0])) as fh:
        rec = json.load(fh)
    assert rec["strategy"] == "serve" and rec["mesh"] == "16x16"
    assert rec["memory"]["by_part"]["cache"] > 0
