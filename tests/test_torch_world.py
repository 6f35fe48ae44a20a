"""The port's world (``launch/world.py``): one process a device, the ranks
started by ``spawn``, meeting through a ``file://`` store and the
collectives of ``repro_torch.collectives``.

On the CPU every rank runs on gloo with one torch thread; each world is
joined under its own timeout, which kills every rank. Held here: the
backend choice, the mesh's groups and coordinates, each collective, the
staging path of a gather through host memory (forced on the CPU, where
only a CUDA tensor over gloo would take it), each rank's shard of a whole
tree against numpy's slice of it by its spec, and a failing, a hanging
or an nvcc-running rank turned into an error of the world. The rank
bodies are in ``torch_world_bodies.py``.
"""

import time

import numpy as np
import pytest
import torch

import torch_world_bodies as bodies
from repro_torch import configs
from repro_torch.engine.flat import params_to_numpy
from repro_torch.launch.world import (WorldError, WorldTimeout,
                                      current_world, pick_backend,
                                      rank_devices, run_world)
from repro_torch.models import build
from repro_torch.sharding import DeviceMesh, mesh_device
from test_torch_threads import one_torch_thread  # noqa: F401

WORLD = dict(device="cpu", threads=1, quiet=True)


def test_backend_follows_the_ranks_devices():
    assert pick_backend(["cpu"] * 4) == "gloo"
    assert pick_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert pick_backend(["cuda:0"]) == "nccl"
    assert pick_backend(["cuda:0", "cuda:0", "cuda:1"]) == "gloo"
    with pytest.raises(ValueError):
        pick_backend(["cpu", "cuda:0"])
    assert rank_devices(3, "cpu") == (torch.device("cpu"),) * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rank_devices(2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_world(bodies.hanging_body, 2, timeout=5.0)


def test_collectives_over_the_mesh_groups():
    """A 2 x 2 world: coordinates row-major over (data, model); each
    collective over its axis's group; a gather staged through host memory
    gives the same tensor and counts the bytes of both copies."""
    t0 = time.monotonic()
    out = run_world(bodies.collectives_body, 4, timeout=120.0, **WORLD)
    assert time.monotonic() - t0 < 120.0
    assert current_world() is None
    for r, o in enumerate(out):
        d, m = divmod(r, 2)
        assert o["coords"] == (d, m) and o["device"] == "cpu"
        assert o["backend"] == "gloo"
        row = [2 * d, 2 * d + 1]
        assert o["gathered"].tolist() == [[row[0], row[0] + 0.5,
                                           row[1], row[1] + 0.5]]
        assert o["summed"].tolist() == [float(m + (2 + m)), 2.0]
        assert o["top"].tolist() == [float(row[1])]
        assert o["sent"].tolist() == [float(2 + m)]  # data rank 1's
        assert o["halves"].dtype == torch.bfloat16
        assert o["halves"].tolist() == [float(m)] * 3 + [float(2 + m)] * 3
        assert o["flags"].tolist() == [True, False]
        assert o["staged"].tolist() == (torch.arange(4.0).repeat(2)
                                        + torch.tensor([row[0]] * 4
                                                       + [row[1]] * 4)
                                        ).tolist()
        assert o["staged_bytes"] == 4 * 4 * (1 + 2)


@pytest.mark.parametrize("arch,overrides", [
    ("tinyllama-1.1b", {}), ("gemma2-27b", {}), ("qwen3-moe-30b-a3b", {}),
    ("rwkv6-1.6b", {}), ("hymba-1.5b", {}),
    ("hymba-1.5b", {"n_heads": 5, "n_kv_heads": 5}),
    ("whisper-large-v3", {}), ("llava-next-mistral-7b", {})],
    ids=["tinyllama-1.1b", "gemma2-27b", "qwen3-moe-30b-a3b", "rwkv6-1.6b",
         "hymba-1.5b", "hymba-1.5b-5-heads", "whisper-large-v3",
         "llava-next-mistral-7b"])
def test_each_rank_holds_its_specs_slice(arch, overrides):
    """``local_shard`` gives each rank of a 2 x 2 world numpy's slice of
    every leaf by the world's spec (split leaves included), and
    ``gather_tree`` gives the whole tree back on every rank; the same for
    a cache. The world's rules, leaf by leaf: RWKV-6's token shifts whole
    over ``model`` and its state split by heads (``token_shift_whole``);
    Hymba's ``in_proj`` a rank's d_inner lanes of both halves
    (``in_proj_halves``, whose slice numpy's oracle takes block by block);
    with 5 heads, which the axis does not divide, Hymba's attention and
    its k / v cache whole over ``model`` (``attention_whole``); Whisper's
    two attentions, MLPs and tied vocab and its self and cross k / v
    cache split over ``model`` (``enc_pos`` whole), and LLaVA's as the
    dense backbone's."""
    from repro_torch.sharding import Blocks

    cfg = configs.reduced(configs.get_config(arch)).with_(**overrides)
    params = params_to_numpy(build(cfg).init(torch.Generator().manual_seed(0),
                                             "cpu"))
    out = run_world(bodies.shard_body, 4, args=(arch, params, overrides),
                    timeout=120.0, **WORLD)
    for o in out:
        assert o["same"] and o["whole"]
        assert o["cache"]["same"] and o["cache"]["whole"]
    assert all(o["split"] == out[0]["split"] > 0 for o in out)
    specs, shapes = out[0]["specs"], out[0]["shapes"]
    cspecs, cshapes = out[0]["cache"]["specs"], out[0]["cache"]["shapes"]
    d = cfg.d_model
    if arch == "rwkv6-1.6b":
        for name in ("last_tm", "last_cm"):
            assert cspecs[name] == (None, "data", None)
            assert cshapes[name] == (2, 2, d)
        assert cspecs["S"] == (None, "data", "model", None, None)
        assert cshapes["S"] == (2, 2, 2, 32, 32)
        assert specs["layers/tm/wr"] == (None, None, "model")
        assert shapes["layers/tm/u"] == (2, 2, 32)
    if arch == "hymba-1.5b":
        assert specs["layers/mamba/in_proj"] == (None, None,
                                                 Blocks("model", 2))
        assert shapes["layers/mamba/in_proj"] == (2, d, d)
        assert shapes["layers/mamba/conv_b"] == (2, d // 2)
        heads = cfg.n_heads * 32
        if overrides:
            for w in ("wq", "wk", "wv", "wo"):
                assert "model" not in specs[f"layers/attn/{w}"]
            assert shapes["layers/attn/wq"] == (2, d, heads)
            for name in ("k", "v"):
                assert cspecs[name] == (None, "data", None, None, None)
                assert cshapes[name] == (2, 2, 8, 5, 32)
        else:
            assert shapes["layers/attn/wq"] == (2, d, heads // 2)
            assert cspecs["k"] == (None, "data", None, "model", None)
    else:
        assert not any(isinstance(a, Blocks) for s in specs.values()
                       for a in s)
    if arch == "whisper-large-v3":
        for stack in ("encoder", "decoder"):
            assert shapes[f"{stack}/mlp/wi"] == (2, d, cfg.d_ff // 2)
            assert shapes[f"{stack}/attn/wo"] == (2, 64, d)
        assert shapes["decoder/xattn/wq"] == (2, d, 64)
        assert specs["enc_pos"] == (None, None)
        assert shapes["embed"] == (cfg.vocab // 2, d)
        for name in ("k", "v", "xk", "xv"):
            assert cspecs[name] == (None, "data", None, "model", None)
        assert cshapes["xk"] == (2, 2, cfg.n_frames, 2, 32)
    if arch == "llava-next-mistral-7b":
        assert shapes["layers/mlp/wd"] == (2, cfg.d_ff // 2, d)
        assert shapes["lm_head"] == (d, cfg.vocab // 2)
        assert cshapes["k"] == (2, 2, 8, 2, 32)


def test_failing_rank_fails_the_world():
    t0 = time.monotonic()
    with pytest.raises(WorldError, match="rank 1 of 2 failed") as e:
        run_world(bodies.failing_body, 2, timeout=60.0, **WORLD)
    assert "rank one gives up" in str(e.value)
    assert "ValueError" in str(e.value)
    assert time.monotonic() - t0 < 60.0


def test_hanging_rank_is_killed_at_the_timeout():
    t0 = time.monotonic()
    with pytest.raises(WorldTimeout, match=r"ranks \[1\] had not finished"):
        run_world(bodies.hanging_body, 2, timeout=8.0, **WORLD)
    assert time.monotonic() - t0 < 30.0


def test_a_rank_may_not_run_nvcc_and_engines_take_the_world():
    """A rank loads only the kernels its parent built; inside a world
    ``make_engine("sharded")`` splits N over every rank."""
    msgs = run_world(bodies.nvcc_body, 2, timeout=60.0, **WORLD)
    assert all(m and "may not run nvcc" in m for m in msgs)
    engines = run_world(bodies.engine_body, 2, timeout=60.0, **WORLD)
    assert [e["rank"] for e in engines] == [0, 1]
    assert all(e["is_mesh"] and e["shards"] == 2 for e in engines)


def test_distinct_devices_outside_a_world_name_the_world():
    mesh = DeviceMesh(("cpu", "meta"), ("data", "model"), (2, 1))
    with pytest.raises(NotImplementedError, match="start a world"):
        mesh_device(mesh)
    assert not mesh.in_world
    assert mesh_device(DeviceMesh(("cpu",) * 2, ("model",), (2,))) == \
        torch.device("cpu")
    grid = DeviceMesh(("cpu",) * 8, ("data", "model"), (4, 2), rank=5)
    assert grid.coords == (2, 1) and grid.axis_index(("data", "model")) == 5
    assert grid.axis_size(("data", "model")) == 8
    assert grid.axis_index("model") == 1 and grid.axis_index(None) == 0
    with pytest.raises(ValueError, match="rank 8"):
        DeviceMesh(("cpu",) * 8, ("data", "model"), (4, 2), rank=8)


def test_launchers_start_a_world(capfd):
    """``--world``: the mesh launcher's rounds and the serving launcher's
    tokens on a 2 x 2 world equal the one-process launcher's; rank 0
    alone prints the lines, every rank draws the same history."""
    from repro_torch.launch import serve, train

    argv = ["--mode", "mesh", "--devices", "4", "--model-parallel", "2",
            "--rounds", "2", "--failure-rate", "0.3", "--device", "cpu"]
    one = train.main(argv)
    capfd.readouterr()
    got = train.main(argv + ["--world"])
    lines = capfd.readouterr().out.splitlines()
    assert lines[0].startswith("[world] ranks=4 backend=gloo")
    assert sum(ln.startswith("[train:mesh] round=") for ln in lines) == 2
    assert sum(ln == "[train:mesh] done" for ln in lines) == 1
    for g, w in zip(got["history"], one["history"]):
        assert g["round"] == w["round"] and g["active"] == w["active"]
        assert abs(g["loss"] - w["loss"]) <= 1e-5 * (1 + abs(w["loss"]))
    assert len({r["history_hash"] for r in got["ranks"]}) == 1
    # the replicas' change over the rounds, sketched on every rank: alike
    # on every rank and within 3e-5 relative of the one process's (3.4e-6
    # measured; a change left out would be 1 off)
    want = one["change_sketch"].numpy()
    assert all(r["change_sketch"] == got["ranks"][0]["change_sketch"]
               for r in got["ranks"])
    gap = np.linalg.norm(np.asarray(got["ranks"][0]["change_sketch"])
                         - want) / np.linalg.norm(want)
    assert gap <= 3e-5 and np.abs(want).max() > 0
    assert [r["rank"] for r in got["ranks"]] == [0, 1, 2, 3]
    assert all(r["backend"] == "gloo" and r["staged_bytes"] == 0
               for r in got["ranks"])

    argv = ["--devices", "4", "--model-parallel", "2", "--new-tokens", "4",
            "--device", "cpu"]
    one = serve.main(argv)
    got = serve.main(argv + ["--world"], teacher=one["tokens"][:, :3])
    assert np.array_equal(got["tokens"], one["tokens"])
    assert len(got["step_logits"]) == 4 and len(got["ranks"]) == 4
    assert got["step_logits"][0].shape == (4, 512)


def test_world_builds_every_family_and_granularity():
    """In a world (a mesh with a rank) the trainer and server of every LM
    family and participant granularity, with a gradient clip and on a
    ``pod`` axis, build, ``shard_seq`` too; no process is started. A MoE
    batch whose rank rows split routing groups, a cache split by sequence
    and kv heads the ``model`` axis does not divide run in
    ``test_torch_world_seqcache.py`` and ``test_torch_world_moe_groups.py``.
    """
    from repro_torch.config import H100, MeshConfig, TrainConfig
    from repro_torch.core.distributed import DistributedTrainer, Server

    mesh = DeviceMesh(("cpu",) * 8, ("data", "model"), (4, 2), rank=3)
    mcfg = MeshConfig(data=4, model=2)
    dense = configs.reduced(configs.get_config("tinyllama-1.1b"))
    arctic = configs.reduced(configs.get_config("arctic-480b"))
    kw = dict(mesh=mesh, device="cpu")
    for arch in ("qwen3-moe-30b-a3b", "rwkv6-1.6b", "hymba-1.5b",
                 "whisper-large-v3", "llava-next-mistral-7b"):
        cfg = configs.reduced(configs.get_config(arch))
        assert DistributedTrainer(cfg, TrainConfig(), mcfg, **kw).world is mesh
        assert Server(cfg, mcfg, **kw).world is mesh
        assert Server(cfg, mcfg, shard_seq=True, **kw).world is mesh
    for gran in ("pod", "chip"):
        for cfg in (dense, arctic):
            cfg = cfg.with_(participant_granularity=gran)
            assert DistributedTrainer(cfg, TrainConfig(grad_clip=1.0), mcfg,
                                      **kw).world is mesh
            assert Server(cfg, mcfg, **kw).world is mesh
    pod_mesh = DeviceMesh(("cpu",) * 8, ("pod", "data", "model"), (2, 2, 2),
                          rank=5)
    pod_cfg = MeshConfig(multi_pod=True, pods=2, data=2, model=2)
    assert DistributedTrainer(dense, TrainConfig(grad_clip=1.0), pod_cfg,
                              mesh=pod_mesh, device="cpu").world is pod_mesh
    assert mesh_device(mesh) == torch.device("cpu")
    # a world's mix on the CPU gathers P (the one-process arithmetic)
    tr = DistributedTrainer(dense, TrainConfig(), mcfg, **kw)
    assert tr.mix_form({}) == "gather"
    # the form is the state's: replicas that would take more than half the
    # card's memory once gathered over data reduce the mean instead
    big = {"w": torch.empty((1, int(H100.hbm_bytes) // 8), device="meta")}
    assert tr.mix_form(big) == "reduce"
    assert DistributedTrainer(dense, TrainConfig(), mcfg, strategy="dsgd",
                              **kw).mix_form(big) == "gather"
    assert tr.local_participants == 1
