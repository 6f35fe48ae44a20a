"""Rank bodies of the port's world tests (``tests/test_torch_world*.py``).

A world's ranks start by ``spawn`` and import the function they run from
its module, so the bodies live here, in a module that imports only torch,
numpy and the port: a rank starts without importing jax or the reference.
Every body takes its :class:`~repro_torch.launch.world.World` first and
returns plain values, numpy arrays or CPU tensors.
"""

import time

import numpy as np
import torch

from repro_torch import collectives, configs
from repro_torch.config import MeshConfig, ModestConfig, TrainConfig
from repro_torch.utils.pytree import tree_flatten, tree_leaves, tree_map

TRAIN_MESH = MeshConfig(data=4, model=2)


# ---------------------------------------------------------------------------
# the world itself
# ---------------------------------------------------------------------------


def slice_by_spec(a, spec, dims, axes, coords):
    """numpy's slice of the whole ``a`` that ``spec`` gives the rank at
    ``coords`` of a mesh of ``dims`` over ``axes``: written out here, apart
    from ``sharding.local_shard``, as the tests' oracle."""
    size = dict(zip(axes, dims))
    at = dict(zip(axes, coords))
    for d, axis in enumerate(tuple(spec)[:a.ndim]):
        blocks = getattr(axis, "n", 1)          # a world rule's Blocks
        axis = getattr(axis, "axis", axis)
        names = () if axis is None else (
            axis if isinstance(axis, tuple) else (axis,))
        n, i = 1, 0
        for name in names:
            n *= size.get(name, 1)
            i = i * size.get(name, 1) + at.get(name, 0)
        if n > 1:
            block = a.shape[d] // blocks
            step = block // n
            a = np.concatenate(
                [np.take(a, np.arange(b * block + i * step,
                                      b * block + (i + 1) * step), axis=d)
                 for b in range(blocks)], axis=d)
    return a


def collectives_body(world):
    """The mesh's groups and coordinates, each collective over them, the
    staging path (forced on the CPU) and the mesh device."""
    from repro_torch.launch import mesh as lm
    from repro_torch.launch.world import current_world
    from repro_torch.sharding import mesh_device

    mesh = lm.make_mesh_from_config(MeshConfig(data=2, model=2), "cpu")
    assert current_world() is world
    assert lm.make_mesh((2, 2), ("data", "model")) is mesh
    r = float(world.rank)
    gathered = collectives.all_gather(
        torch.tensor([[r, r + 0.5]]), mesh.group("model"), dim=1)
    summed = collectives.all_reduce(torch.tensor([r, 1.0]),
                                    mesh.group("data"))
    top = collectives.all_reduce(torch.tensor([r]), mesh.group("model"),
                                 "max")
    sent = collectives.broadcast(torch.tensor([r]), 1, mesh.group("data"))
    halves = collectives.all_gather(
        torch.full((3,), r, dtype=torch.bfloat16), mesh.group("data"))
    flags = collectives.all_gather(torch.tensor([world.rank % 2 == 0]),
                                   mesh.group("model"))
    collectives.reset_counts()
    real = collectives._needs_staging
    collectives._needs_staging = lambda x, group: True
    try:
        staged = collectives.all_gather(torch.arange(4.0) + r,
                                        mesh.group("model"))
    finally:
        collectives._needs_staging = real
    return {"coords": mesh.coords, "device": str(mesh_device(mesh)),
            "gathered": gathered, "summed": summed, "top": top,
            "sent": sent, "halves": halves, "flags": flags,
            "staged": staged,
            "staged_bytes": collectives.COUNTS["staged_bytes"],
            "backend": collectives.backend(mesh.group("model"))}


def shard_body(world, arch, params_np, overrides=None):
    """Each rank's shard of a whole tree (``local_shard`` by the world's
    specs) against numpy's slice, and ``gather_tree`` back to the whole;
    the same for a whole cache of random values (B 4, 8 positions) by the
    world's cache specs. Returns the specs by path too."""
    from repro_torch.core.distributed import Server
    from repro_torch.engine.flat import params_from_numpy
    from repro_torch.launch.mesh import make_mesh_from_config
    from repro_torch.sharding import gather_tree, local_shard
    from repro_torch.utils.pytree import tree_flatten_with_path

    cfg = configs.reduced(configs.get_config(arch)).with_(**(overrides or {}))
    mcfg = MeshConfig(data=2, model=2)
    mesh = make_mesh_from_config(mcfg, "cpu")
    server = Server(cfg, mcfg, mesh=mesh, device="cpu")
    params = params_from_numpy(params_np, "cpu")
    gen = torch.Generator().manual_seed(0)        # alike on every rank
    cache = tree_map(lambda x: torch.rand(x.shape, generator=gen).to(x.dtype)
                     if isinstance(x, torch.Tensor) else x,
                     server.model.init_cache(4, 8, "cpu"))
    pspec, cspec = server.specs(params, cache)
    out = {}
    for name, tree, specs in (("params", params, pspec),
                              ("cache", cache, cspec)):
        mine = local_shard(tree, specs, mesh)
        flat = tree_flatten(tree)[1].flatten_up_to(specs)
        leaves = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
        specs_t = [s for x, s in zip(tree_leaves(tree), flat)
                   if isinstance(x, torch.Tensor)]
        got = [x for x in tree_leaves(mine) if isinstance(x, torch.Tensor)]
        want = [slice_by_spec(x.numpy(), s, mcfg.shape, mcfg.axes,
                              mesh.coords) for x, s in zip(leaves, specs_t)]
        back = [x for x in tree_leaves(gather_tree(mine, specs, mesh))
                if isinstance(x, torch.Tensor)]
        out[name] = {
            "same": all(np.array_equal(g.numpy(), w)
                        for g, w in zip(got, want)),
            "split": sum(g.numel() < x.numel() for g, x in zip(got, leaves)),
            "whole": all(torch.equal(b, x) for b, x in zip(back, leaves)),
            "specs": {"/".join(str(getattr(k, "key", k)) for k in path): s
                      for (path, _), s in zip(
                          tree_flatten_with_path(tree)[0], flat)},
            "shapes": {"/".join(str(getattr(k, "key", k)) for k in path):
                       tuple(g.shape) for (path, _), g in zip(
                           tree_flatten_with_path(mine)[0],
                           tree_leaves(mine)) if isinstance(g, torch.Tensor)}}
    # the params' answer in the old keys, for the callers that read them
    return {**out["params"], "cache": out["cache"]}


def failing_body(world):
    if world.rank == 1:
        raise ValueError("rank one gives up")
    time.sleep(600)               # the others wait in vain: killed


def hanging_body(world):
    if world.rank == 1:
        time.sleep(600)
    return world.rank


def nvcc_body(world):
    """A rank may only load the kernels its parent built."""
    from repro_torch.kernels import build
    try:
        build.build(["fused_agg"])
    except RuntimeError as e:
        return str(e)
    return None


def engine_body(world):
    """``make_engine("sharded")`` inside the world."""
    from repro_torch.engine import MeshEngine, make_engine
    from repro_torch.models.tasks import cnn_task

    eng = make_engine("sharded", cnn_task(device="cpu"), device="cpu")
    return {"type": type(eng).__name__, "shards": eng.shardings.n_shards,
            "rank": eng.shardings.rank,
            "is_mesh": isinstance(eng, MeshEngine)}


# ---------------------------------------------------------------------------
# the sharded engine across ranks
# ---------------------------------------------------------------------------


def cnn_session(engine, secure_agg, init=None, device="cpu"):
    """``tests/sharded_child.py``'s session: the paper CNN on 8 nodes in
    cohorts of 3, from ``init`` (numpy, the reference's) where given."""
    from repro_torch.data import make_classification_task
    from repro_torch.engine.flat import params_from_numpy
    from repro_torch.models.tasks import cnn_task
    from repro_torch.sim.runner import ModestSession

    task = cnn_task(device=device)
    if init is not None:
        task.init_params = lambda seed=0: params_from_numpy(init, device)
    return ModestSession(
        n_nodes=8, mcfg=ModestConfig(n_nodes=8, sample_size=3,
                                     n_aggregators=1, secure_agg=secure_agg),
        tcfg=TrainConfig(batch_size=10, seed=0), task=task,
        data=make_classification_task(8, seed=0), seed=0,
        eval_every_rounds=5, engine=engine, device=device)


def quantized_aggregates(task, shardings, device="cpu"):
    """``sharded_child.fingerprint``'s fused aggregate→quantize of five
    seeded models, plain and masked (the masked call's codes and scales
    must equal the plain call's bit for bit)."""
    from repro_torch.engine.flat import FlatModel
    from repro_torch.kernels.ops import (aggregate_flatmodel,
                                         masked_aggregate_flatmodel)
    from repro_torch.secureagg import PairwiseMasker

    spec = task.flat_spec
    rng = np.random.default_rng(0)
    models = [FlatModel(torch.from_numpy(rng.standard_normal(spec.n).astype(
        np.float32)).to(device), spec) for _ in range(5)]
    weights = list(rng.random(5) + 0.1)
    plain = aggregate_flatmodel(models, weights, spec=spec, quantize=True,
                                device=device, shardings=shardings)
    masker = PairwiseMasker(0)
    roster = tuple(f"n{i}" for i in range(len(models)))
    sealed = [masker.seal(m, roster[i], 7, roster, spec.nbytes)
              for i, m in enumerate(models)]
    secrets = {nid: masker.secret(nid, 7) for nid in roster}
    seeds, signs = masker.unmask_matrices(sealed, secrets)
    masked = masked_aggregate_flatmodel(
        [sm.payload for sm in sealed], weights, seeds=seeds, signs=signs,
        spec=spec, quantize=True, device=device, shardings=shardings)
    return ([plain[0].buffer, plain[1], plain[2]],
            [masked[0].buffer, masked[1], masked[2]])


def session_body(world, init, secure_aggs, duration):
    """The CNN session through ``MeshEngine`` on this world, for each of
    ``secure_aggs``: trajectory, every aggregation's mean, the final model,
    the state's lanes and the quantised aggregates; rank 0 alone returns
    the tensors, every rank its own digest of them."""
    from repro_torch.engine import MeshEngine

    out = []
    for secure_agg in secure_aggs:
        t0 = time.perf_counter()
        session = cnn_session("sharded", secure_agg, init)
        eng = session.engine
        assert isinstance(eng, MeshEngine), type(eng)
        means = []
        for name in ("aggregate", "aggregate_masked"):
            inner = getattr(eng, name)

            def call(*a, _inner=inner, **kw):
                got = _inner(*a, **kw)
                means.append(got.buffer.clone())
                return got

            setattr(eng, name, call)
        res = session.run(duration)
        last = max(session._eval_models)
        final = session._eval_models[last].buffer
        plain, masked = quantized_aggregates(session.task, eng.shardings)
        tensors = [final, *means, *plain, *masked]
        out.append({
            "rounds": res.rounds_completed, "round_times": res.round_times,
            "total_bytes": res.usage["total_bytes"],
            "history": res.history, "state_lanes": eng.state_lanes,
            "n_shards": eng.shardings.n_shards, "flushes": eng.flushes,
            "digest": [float(t.double().sum()) for t in tensors],
            "seconds": time.perf_counter() - t0,
            "tensors": ({"final": final, "means": means, "plain": plain,
                         "masked": masked} if world.rank == 0 else None)})
    return out


# ---------------------------------------------------------------------------
# the mesh round and serving across ranks
# ---------------------------------------------------------------------------


def _train_cfg():
    return configs.reduced(configs.get_config("tinyllama-1.1b"))


def whole_state(trainer, params):
    """The trainer's whole state from one model: P copies of ``params``
    (a tree of tensors) and its optimizer and server state."""
    from repro_torch.core.distributed import TrainState

    P = trainer.policy.n_participants
    copies = tree_map(lambda x: x[None].repeat((P,) + (1,) * x.dim()),
                      params)
    opt = tree_map(lambda x: x[None].repeat((P,) + (1,) * x.dim()),
                   trainer.opt.init(params))
    return TrainState(copies, opt, trainer.strategy.init_state(copies),
                      torch.zeros((), dtype=torch.int32))


def _max_slot_gap(params_P, a=0, b=1):
    return max(float(torch.max(torch.abs(x[a].float() - x[b].float())))
               for x in tree_leaves(params_P))


def trainer_body(world, params_np, toks, runs):
    """``runs``: ``[(strategy, [weights of each round], mix)]`` on a 4 x 2
    world from ``params_np``, ``mix`` ``"auto"`` (the trainer's choice) or
    ``"reduce"`` (the reduction forced, as where the gathered replicas
    would not fit); each round's loss and the largest gap between replicas
    0 and 1 of the gathered parameters and the collectives the step
    issued (``collectives.COUNTS``), the mix's form, the local shapes, and
    the final parameters (rank 0), under ``"strategy/mix"``."""
    from repro_torch.core.distributed import DistributedTrainer
    from repro_torch.engine.flat import params_from_numpy
    from repro_torch.launch.mesh import make_mesh_from_config

    cfg = _train_cfg()
    mesh = make_mesh_from_config(TRAIN_MESH, "cpu")
    batch = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks)}
    out = {}
    for name, weights, mix in runs:
        trainer = DistributedTrainer(cfg, TrainConfig(optimizer="sgd",
                                                      lr=0.1),
                                     TRAIN_MESH, strategy=name, mesh=mesh,
                                     device="cpu")
        if mix == "reduce":           # as where memory forbids the gather
            trainer.mix_form = lambda new_P: "reduce"
        state = trainer.shard_state(
            whole_state(trainer, params_from_numpy(params_np, "cpu")))
        step = trainer.jit_train_step()
        rounds = []
        for w in weights:
            collectives.reset_counts()
            state, m = step(state, batch, torch.tensor(w, dtype=torch.float32))
            counts = dict(collectives.COUNTS)
            whole = trainer.gather_state(state)
            rounds.append({"loss": float(m["loss"]),
                           "active": float(m["active"]),
                           "gap": _max_slot_gap(whole.params),
                           "counts": counts})
        out[f"{name}/{mix}"] = {
            "rounds": rounds, "form": trainer.mix_form(state.params),
            "local": [tuple(x.shape) for x in tree_leaves(state.params)],
            "digest": [float(x.double().sum())
                       for x in tree_leaves(whole.params)],
            "final": whole.params if world.rank == 0 else None}
    return out


def serve_body(world, params_np, tokens, max_len):
    """The reduced gemma2-27b served on a 4 x 2 world from ``params_np``:
    a prefill of ``tokens`` and one greedy decode; the whole logits, and
    whether every rank's parameter and cache shards are their specs'
    slices of the whole ones (the cache's against ``one_cache``, the
    one-process cache, passed back by rank 0)."""
    from repro_torch.core.distributed import Server
    from repro_torch.engine.flat import params_from_numpy
    from repro_torch.launch.mesh import make_mesh_from_config

    cfg = configs.reduced(configs.get_config("gemma2-27b"))
    mesh = make_mesh_from_config(TRAIN_MESH, "cpu")
    server = Server(cfg, TRAIN_MESH, mesh=mesh, device="cpu")
    whole = params_from_numpy(params_np, "cpu")
    params = server.shard_params(whole)
    cache = server.shard_cache(server.model.init_cache(tokens.shape[0],
                                                       max_len, "cpu"))
    pspec, cspec = server.specs(whole, server.model.init_cache(
        tokens.shape[0], max_len, "cpu"))
    treedef = tree_flatten(whole)[1]
    shards_ok = all(np.array_equal(
        m.numpy(), slice_by_spec(a, s, TRAIN_MESH.shape, TRAIN_MESH.axes,
                                 mesh.coords))
        for m, a, s in zip(tree_leaves(params), tree_leaves(params_np),
                           treedef.flatten_up_to(pspec)))
    logits, cache = server.prefill(params, {"tokens": torch.as_tensor(
        tokens)}, cache)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    dlogits, cache = server.decode(params, tok, cache)
    cache_spec = {k: v for k, v in cspec.items() if k != "pos"}
    return {"prefill": logits, "decode": dlogits, "tok": tok,
            "params_are_slices": shards_ok, "coords": mesh.coords,
            "cache": {k: cache[k] for k in cache_spec},
            "cache_spec": cache_spec, "pos": cache["pos"]}


def grad_body(world, params_np, toks, drop_f=False):
    """Every leaf's gradient of the reduced TinyLlama's loss on a 1 x 2
    world (vocab-parallel embedding and loss, column- and row-parallel
    products), gathered by its spec, and the loss. ``drop_f``: a control
    with Megatron's *f* made the identity in this rank, so the gradient of
    a column-parallel product's input is not summed over the group."""
    if drop_f:
        from repro_torch import collectives
        collectives.copy_to_group = lambda x, group: x
    from repro_torch.engine.flat import params_from_numpy
    from repro_torch.engine.lowering import looped_value_and_grad
    from repro_torch.launch.mesh import make_mesh_from_config
    from repro_torch.models import build
    from repro_torch.models import layers as L
    from repro_torch.sharding import (ShardingPolicy, gather_tree,
                                      local_shard)

    cfg = _train_cfg()
    mcfg = MeshConfig(data=1, model=2)
    mesh = make_mesh_from_config(mcfg, "cpu")
    params = params_from_numpy(params_np, "cpu")
    spec = ShardingPolicy(cfg, mcfg).param_spec(params,
                                                with_participants=False)
    mine = tree_map(lambda x: x[None], local_shard(params, spec, mesh))
    batch = {"tokens": torch.as_tensor(toks)[None],
             "labels": torch.as_tensor(toks)[None]}
    with L.tensor_parallel(mesh):
        loss, grads = looped_value_and_grad(build(cfg).loss_fn)(mine, batch)
    return {"loss": loss[0],
            "grads": gather_tree(tree_map(lambda g: g[0], grads), spec,
                                 mesh),
            "split": sum(m.numel() < p.numel() for m, p in zip(
                tree_leaves(mine), tree_leaves(params)))}


# ---------------------------------------------------------------------------
# the MoE across ranks (experts over ``model``)
# ---------------------------------------------------------------------------

MOE_MESH = MeshConfig(data=2, model=2)


def moe_grad_body(world, arch, params_np, toks, drop_f=False):
    """Every leaf's gradient of a reduced MoE's loss (qwen3-moe or arctic,
    whose dense residual splits too) on a 1 x 2 world, gathered by its
    spec, the loss, and the number of leaves split. ``drop_f``: a control
    with Megatron's *f* left off ``combine`` in this rank (the slices'
    gradients not summed over the group before they reach the gates)."""
    from repro_torch.engine.flat import params_from_numpy
    from repro_torch.engine.lowering import looped_value_and_grad
    from repro_torch.launch.mesh import make_mesh_from_config
    from repro_torch.models import build
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.sharding import (ShardingPolicy, gather_tree,
                                      local_shard)

    if drop_f:
        moe._combine_in = lambda combine, group: combine
    cfg = configs.reduced(configs.get_config(arch))
    mcfg = MeshConfig(data=1, model=2)
    mesh = make_mesh_from_config(mcfg, "cpu")
    params = params_from_numpy(params_np, "cpu")
    spec = ShardingPolicy(cfg, mcfg).param_spec(params,
                                                with_participants=False)
    mine = tree_map(lambda x: x[None], local_shard(params, spec, mesh))
    batch = {"tokens": torch.as_tensor(toks)[None],
             "labels": torch.as_tensor(toks)[None]}
    collectives.reset_counts()
    with L.tensor_parallel(mesh):
        loss, grads = looped_value_and_grad(build(cfg).loss_fn)(mine, batch)
    counts = dict(collectives.COUNTS)
    return {"loss": loss[0], "counts": counts,
            "grads": gather_tree(tree_map(lambda g: g[0], grads), spec,
                                 mesh),
            "split": sum(m.numel() < p.numel() for m, p in zip(
                tree_leaves(mine), tree_leaves(params)))}


def moe_world_body(world, params_np, toks, weights, serve_np, tokens,
                   max_len):
    """The reduced qwen3-moe on a 2 x 2 world: MoDeST rounds of ``weights``
    (P = 2 over ``data``, experts over ``model``), each round's loss and
    the final parameters (rank 0); then, from ``serve_np``, a prefill of
    ``tokens`` and one greedy decode, with the local shapes of the experts
    and the cache."""
    from repro_torch.core.distributed import DistributedTrainer, Server
    from repro_torch.engine.flat import params_from_numpy
    from repro_torch.launch.mesh import make_mesh_from_config

    cfg = configs.reduced(configs.get_config("qwen3-moe-30b-a3b"))
    mesh = make_mesh_from_config(MOE_MESH, "cpu")
    trainer = DistributedTrainer(cfg, TrainConfig(optimizer="sgd", lr=0.1),
                                 MOE_MESH, strategy="modest", mesh=mesh,
                                 device="cpu")
    state = trainer.shard_state(
        whole_state(trainer, params_from_numpy(params_np, "cpu")))
    step = trainer.jit_train_step()
    batch = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks)}
    losses = []
    for w in weights:
        state, m = step(state, batch, torch.tensor(w, dtype=torch.float32))
        losses.append(float(m["loss"]))
    whole = trainer.gather_state(state)
    experts = tuple(state.params["layers"]["moe"]["wg"].shape)

    server = Server(cfg, MOE_MESH, mesh=mesh, device="cpu")
    params = server.shard_params(params_from_numpy(serve_np, "cpu"))
    cache = server.shard_cache(server.model.init_cache(tokens.shape[0],
                                                       max_len, "cpu"))
    collectives.reset_counts()
    logits, cache = server.prefill(params, {"tokens": torch.as_tensor(
        tokens)}, cache)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    dlogits, cache = server.decode(params, tok, cache)
    return {"losses": losses, "experts": experts,
            "final": whole.params if world.rank == 0 else None,
            "prefill": logits, "decode": dlogits, "tok": tok,
            "served_experts": tuple(params["layers"]["moe"]["wg"].shape),
            "cache": tuple(cache["k"].shape), "pos": cache["pos"],
            "serve_counts": dict(collectives.COUNTS)}


# ---------------------------------------------------------------------------
# RWKV-6 and Hymba across ranks (heads and d_inner over ``model``)
# ---------------------------------------------------------------------------

RECURRENT_MESH = MeshConfig(data=2, model=2)


def _drop_f(which):
    """A control: Megatron's *f* left off where the family needs it, in
    this rank (``decay_a``: before RWKV-6's ``decay_b``; ``dt_bc``: after
    Hymba's ``dt_proj`` and ``bc_proj`` sums)."""
    from repro_torch.models import hymba, rwkv
    from repro_torch.models import layers as L
    if which == "decay_a":
        rwkv._decay_in = lambda h, split: h
    elif which == "dt_bc":
        hymba._summed = lambda y, split: L._reduce_out(y, split)


def recurrent_grad_body(world, arch, params_np, toks, overrides=None,
                        drop_f=None):
    """Every leaf's gradient of a reduced RWKV-6 or Hymba loss on a 1 x 2
    world, the rank's shards taken by the world's specs and the gradients
    gathered by them; the loss, the leaves split and the collectives the
    step issued (``collectives.COUNTS``). ``drop_f``: a control of
    :func:`_drop_f`."""
    from repro_torch.engine.flat import params_from_numpy
    from repro_torch.engine.lowering import looped_value_and_grad
    from repro_torch.launch.mesh import make_mesh_from_config
    from repro_torch.models import build
    from repro_torch.models import layers as L
    from repro_torch.sharding import (ShardingPolicy, gather_tree,
                                      local_shard)

    _drop_f(drop_f)
    cfg = configs.reduced(configs.get_config(arch)).with_(**(overrides or {}))
    mcfg = MeshConfig(data=1, model=2)
    mesh = make_mesh_from_config(mcfg, "cpu")
    params = params_from_numpy(params_np, "cpu")
    spec = ShardingPolicy(cfg, mcfg).param_spec(
        params, with_participants=False, world=True)
    mine = tree_map(lambda x: x[None], local_shard(params, spec, mesh))
    batch = {"tokens": torch.as_tensor(toks)[None],
             "labels": torch.as_tensor(toks)[None]}
    collectives.reset_counts()
    with L.tensor_parallel(mesh):
        loss, grads = looped_value_and_grad(build(cfg).loss_fn)(mine, batch)
    counts = dict(collectives.COUNTS)
    return {"loss": loss[0], "counts": counts,
            "grads": gather_tree(tree_map(lambda g: g[0], grads), spec,
                                 mesh),
            "split": sum(m.numel() < p.numel() for m, p in zip(
                tree_leaves(mine), tree_leaves(params)))}


def recurrent_world_body(world, arch, params_np, toks, weights, tokens,
                         max_len, starts=()):
    """A reduced RWKV-6 or Hymba on a 2 x 2 world: MoDeST rounds of
    ``weights`` from ``params_np`` (P = 2 over ``data``, heads and d_inner
    over ``model``), each round's loss and parameters (rank 0); then, from
    the same initial weights, a prefill of ``tokens`` and one greedy
    decode, with the local shapes of the cache and the collectives the
    serving issued. ``starts``: ``(round, replicas)`` pairs, each a round
    run once more on its own from the given (P-stacked) replicas (rank 0
    returns them under ``"isolated"``)."""
    from repro_torch.core.distributed import DistributedTrainer, Server
    from repro_torch.engine.flat import params_from_numpy
    from repro_torch.launch.mesh import make_mesh_from_config

    cfg = configs.reduced(configs.get_config(arch))
    mesh = make_mesh_from_config(RECURRENT_MESH, "cpu")
    trainer = DistributedTrainer(cfg, TrainConfig(optimizer="sgd", lr=0.1),
                                 RECURRENT_MESH, strategy="modest",
                                 mesh=mesh, device="cpu")
    state = trainer.shard_state(
        whole_state(trainer, params_from_numpy(params_np, "cpu")))
    step = trainer.jit_train_step()
    batch = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks)}
    losses, finals = [], []
    for w in weights:
        state, m = step(state, batch, torch.tensor(w, dtype=torch.float32))
        losses.append(float(m["loss"]))
        whole = trainer.gather_state(state)
        finals.append(whole.params if world.rank == 0 else None)
    isolated = {}
    for r, replicas in starts:
        start = whole_state(trainer, params_from_numpy(params_np, "cpu"))
        start = trainer.shard_state(start._replace(
            params=params_from_numpy(replicas, "cpu")))
        out, _ = step(start, batch, torch.tensor(weights[r],
                                                 dtype=torch.float32))
        out = trainer.gather_state(out)
        isolated[r] = out.params if world.rank == 0 else None

    server = Server(cfg, RECURRENT_MESH, mesh=mesh, device="cpu")
    params = server.shard_params(params_from_numpy(params_np, "cpu"))
    cache = server.shard_cache(server.model.init_cache(tokens.shape[0],
                                                       max_len, "cpu"))
    collectives.reset_counts()
    logits, cache = server.prefill(params, {"tokens": torch.as_tensor(
        tokens)}, cache)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    dlogits, cache = server.decode(params, tok, cache)
    return {"losses": losses, "rounds": finals, "isolated": isolated,
            "prefill": logits, "decode": dlogits, "tok": tok,
            "cache": {k: tuple(v.shape) for k, v in cache.items()
                      if isinstance(v, torch.Tensor)},
            "pos": cache["pos"], "serve_counts": dict(collectives.COUNTS)}


# ---------------------------------------------------------------------------
# Whisper and LLaVA across ranks (heads, d_ff and vocab over ``model``)
# ---------------------------------------------------------------------------

MULTIMODAL_MESH = MeshConfig(data=2, model=2)


def multimodal_grad_body(world, arch, params_np, batch_np, overrides=None,
                         drop_f=False):
    """Every leaf's gradient of a reduced Whisper or LLaVA loss on a 1 x 2
    world (``batch_np``: one participant's tokens, labels and ``frames``
    or ``image_embeds``), the rank's shards taken by the world's specs and
    the gradients gathered by them; the loss, the leaves split and the
    collectives the step issued (``collectives.COUNTS``). ``drop_f``: the
    control with Megatron's *f* left off Whisper's encoder output
    (``whisper._enc_in``), so its gradient is one rank's heads'."""
    from repro_torch.engine.flat import params_from_numpy
    from repro_torch.engine.lowering import looped_value_and_grad
    from repro_torch.launch.mesh import make_mesh_from_config
    from repro_torch.models import build
    from repro_torch.models import layers as L
    from repro_torch.models import whisper
    from repro_torch.sharding import (ShardingPolicy, gather_tree,
                                      local_shard)

    if drop_f:
        whisper._enc_in = lambda enc, params, cfg: enc
    cfg = configs.reduced(configs.get_config(arch)).with_(**(overrides or {}))
    mcfg = MeshConfig(data=1, model=2)
    mesh = make_mesh_from_config(mcfg, "cpu")
    params = params_from_numpy(params_np, "cpu")
    spec = ShardingPolicy(cfg, mcfg).param_spec(
        params, with_participants=False, world=True)
    mine = tree_map(lambda x: x[None], local_shard(params, spec, mesh))
    batch = {k: torch.as_tensor(v)[None] for k, v in batch_np.items()}
    collectives.reset_counts()
    with L.tensor_parallel(mesh):
        loss, grads = looped_value_and_grad(build(cfg).loss_fn)(mine, batch)
    counts = dict(collectives.COUNTS)
    return {"loss": loss[0], "counts": counts,
            "grads": gather_tree(tree_map(lambda g: g[0], grads), spec,
                                 mesh),
            "split": sum(m.numel() < p.numel() for m, p in zip(
                tree_leaves(mine), tree_leaves(params)))}


def multimodal_world_body(world, arch, params_np, batch_np, weights,
                          serve_np, max_len):
    """A reduced Whisper or LLaVA on a 2 x 2 world: MoDeST rounds of
    ``weights`` from ``params_np`` over ``batch_np`` (``(P, E, B, ...)``
    leaves, ``frames`` or ``image_embeds`` among them; P = 2 over
    ``data``, heads, d_ff and vocab over ``model``), each round's loss and
    parameters (rank 0); then, from the same initial weights, a prefill of
    ``serve_np`` (tokens and the frontend's input) and one greedy decode,
    with the local shapes of the cache and the collectives the serving
    issued."""
    from repro_torch.core.distributed import DistributedTrainer, Server
    from repro_torch.engine.flat import params_from_numpy
    from repro_torch.launch.mesh import make_mesh_from_config

    cfg = configs.reduced(configs.get_config(arch))
    mesh = make_mesh_from_config(MULTIMODAL_MESH, "cpu")
    trainer = DistributedTrainer(cfg, TrainConfig(optimizer="sgd", lr=0.1),
                                 MULTIMODAL_MESH, strategy="modest",
                                 mesh=mesh, device="cpu")
    state = trainer.shard_state(
        whole_state(trainer, params_from_numpy(params_np, "cpu")))
    step = trainer.jit_train_step()
    batch = {k: torch.as_tensor(v) for k, v in batch_np.items()}
    losses, finals = [], []
    for w in weights:
        state, m = step(state, batch, torch.tensor(w, dtype=torch.float32))
        losses.append(float(m["loss"]))
        whole = trainer.gather_state(state)
        finals.append(whole.params if world.rank == 0 else None)

    server = Server(cfg, MULTIMODAL_MESH, mesh=mesh, device="cpu")
    params = server.shard_params(params_from_numpy(params_np, "cpu"))
    prompt = {k: torch.as_tensor(v) for k, v in serve_np.items()}
    cache = server.shard_cache(server.model.init_cache(
        prompt["tokens"].shape[0], max_len, "cpu"))
    collectives.reset_counts()
    logits, cache = server.prefill(params, prompt, cache)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    dlogits, cache = server.decode(params, tok, cache)
    return {"losses": losses, "rounds": finals,
            "prefill": logits, "decode": dlogits, "tok": tok,
            "cache": {k: tuple(v.shape) for k, v in cache.items()
                      if isinstance(v, torch.Tensor)},
            "pos": cache["pos"], "serve_counts": dict(collectives.COUNTS)}


# ---------------------------------------------------------------------------
# participant granularities across ranks (``pod`` as FSDP over ``data``,
# ``chip``, a ``pod`` mesh axis) and the gradient clip
# ---------------------------------------------------------------------------


def _granularity_cfg(arch, gran, **overrides):
    return configs.reduced(configs.get_config(arch)).with_(
        participant_granularity=gran, **overrides)


def granularity_world_body(world, arch, gran, mesh_kw, params_np, batch_np,
                           weights, clip, prompt_np, max_len,
                           controls=False):
    """A reduced ``arch`` at participant granularity ``gran`` on the world
    of ``MeshConfig(**mesh_kw)``: MoDeST rounds of ``weights`` from
    ``params_np`` over ``batch_np`` (``(P, E, B, S)``), SGD at 0.1 with a
    clip of ``clip`` (0: none), each round's loss and gathered parameters
    (rank 0) and the local shapes; then, from the same weights, a prefill
    of ``prompt_np`` and one greedy decode. ``controls``: one round each of
    two controls that must be caught (rank 0's parameters): the step
    without its ``1 / data`` (``core.distributed._data_mean`` made the
    identity; no clip, which would scale the doubled gradient back) and
    the clip's norm taken of a rank's own shards (the sums over the shard
    axes left out). ``mixed_in``: what the strategy's first mix was given
    (rank 0's whole P axis, gathered over the participant axes)."""
    from repro_torch.core import distributed
    from repro_torch.core.distributed import DistributedTrainer, Server
    from repro_torch.engine.flat import params_from_numpy
    from repro_torch.launch.mesh import make_mesh_from_config

    cfg = _granularity_cfg(arch, gran)
    mcfg = MeshConfig(**mesh_kw)
    mesh = make_mesh_from_config(mcfg, "cpu")
    batch = {k: torch.as_tensor(v) for k, v in batch_np.items()}

    mixed = []

    def rounds(tcfg, n=len(weights), local_clip=False):
        trainer = DistributedTrainer(cfg, tcfg, mcfg, strategy="modest",
                                     mesh=mesh, device="cpu")
        if local_clip:
            trainer._reduce_shards = lambda t: t
        real_mix = trainer.strategy.mix

        def recording(prev_P, new_P, *a):
            if not mixed:       # the first mix's input: the whole P axis
                mixed.append(new_P)
            return real_mix(prev_P, new_P, *a)

        trainer.strategy = trainer.strategy._replace(mix=recording)
        state = trainer.shard_state(
            whole_state(trainer, params_from_numpy(params_np, "cpu")))
        step = trainer.jit_train_step()
        losses, finals = [], []
        for w in weights[:n]:
            state, m = step(state, batch, torch.tensor(w,
                                                       dtype=torch.float32))
            losses.append(float(m["loss"]))
            whole = trainer.gather_state(state)
            finals.append(whole.params if world.rank == 0 else None)
        return losses, finals, [tuple(x.shape)
                                for x in tree_leaves(state.params)]

    out = {}
    out["losses"], out["rounds"], out["local"] = rounds(
        TrainConfig(optimizer="sgd", lr=0.1, grad_clip=clip))
    out["mixed_in"] = mixed[0] if world.rank == 0 else None
    if controls:
        real = distributed._data_mean
        distributed._data_mean = lambda grads, n: grads
        try:
            out["no_data_mean"] = rounds(TrainConfig(optimizer="sgd",
                                                     lr=0.1), n=1)[1][0]
        finally:
            distributed._data_mean = real
        out["local_clip"] = rounds(
            TrainConfig(optimizer="sgd", lr=0.1, grad_clip=clip), n=1,
            local_clip=True)[1][0]

    server = Server(cfg, mcfg, mesh=mesh, device="cpu")
    params = server.shard_params(params_from_numpy(params_np, "cpu"))
    cache = server.shard_cache(server.model.init_cache(
        prompt_np.shape[0], max_len, "cpu"))
    collectives.reset_counts()
    logits, cache = server.prefill(params, {"tokens": torch.as_tensor(
        prompt_np)}, cache)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    dlogits, cache = server.decode(params, tok, cache)
    out.update(prefill=logits, decode=dlogits, tok=tok, pos=cache["pos"],
               serve_counts=dict(collectives.COUNTS),
               served=[tuple(x.shape) for x in tree_leaves(params)])
    return out


def granularity_worlds_body(world, cases):
    """:func:`granularity_world_body` of every case (``{name: its
    arguments}``), one after another in one world."""
    return {name: granularity_world_body(world, *args)
            for name, args in cases.items()}


def granularity_grad_body(world, arch, mesh_kw, params_np, batch_np):
    """Every leaf's gradient of a reduced ``arch`` at ``pod`` granularity
    (FSDP over ``data``) on the world of ``MeshConfig(**mesh_kw)``, as a
    step computes it (``DistributedTrainer.grads``), gathered by the
    state's specs, with ``cfg.remat`` off and on: the loss, the gradients
    (rank 0) and the collectives each issued; then the collectives of one
    whole step of the ``local`` strategy (no remat)."""
    from repro_torch.core.distributed import DistributedTrainer
    from repro_torch.engine.flat import params_from_numpy
    from repro_torch.launch.mesh import make_mesh_from_config
    from repro_torch.sharding import gather_tree

    mcfg = MeshConfig(**mesh_kw)
    mesh = make_mesh_from_config(mcfg, "cpu")
    batch = {k: torch.as_tensor(v) for k, v in batch_np.items()}
    out = {}
    for remat in (False, True):
        trainer = DistributedTrainer(
            _granularity_cfg(arch, "pod", remat=remat),
            TrainConfig(optimizer="sgd", lr=0.1), mcfg, mesh=mesh,
            device="cpu")
        state = trainer.shard_state(
            whole_state(trainer, params_from_numpy(params_np, "cpu")))
        collectives.reset_counts()
        loss, grads = trainer.grads(state, batch)
        counts = dict(collectives.COUNTS)
        specs = trainer.state_spec(trainer.abstract_state()).params
        whole = gather_tree(grads, specs, mesh)
        out[remat] = {"loss": loss, "counts": counts,
                      "grads": whole if world.rank == 0 else None}
    trainer = DistributedTrainer(_granularity_cfg(arch, "pod"),
                                 TrainConfig(optimizer="sgd", lr=0.1), mcfg,
                                 strategy="local", mesh=mesh, device="cpu")
    state = trainer.shard_state(
        whole_state(trainer, params_from_numpy(params_np, "cpu")))
    collectives.reset_counts()
    trainer.jit_train_step()(state, batch, torch.ones(
        trainer.policy.n_participants))
    out["step_counts"] = dict(collectives.COUNTS)
    return out


def reduce_scatter_body(world):
    """``collectives.reduce_scatter`` of a bf16 tensor along dim 1 over a
    2-rank ``data`` group, plain and through the staging path (forced on
    the CPU) with its counts, and a staged ``all_gather`` along the last
    dimension, both again for a tensor twice as large (the exchange's
    files grown); ``gather_shards`` forward and its gradient (each rank's
    loss weighted by its rank + 1)."""
    from repro_torch.launch.mesh import make_mesh_from_config

    mesh = make_mesh_from_config(MeshConfig(data=2, model=1), "cpu")
    group, r = mesh.group("data"), world.rank
    x = (torch.arange(8.0).reshape(2, 4) + 10 * r).to(torch.bfloat16)
    plain = collectives.reduce_scatter(x, group, dim=1)
    collectives.reset_counts()
    real = collectives._needs_staging
    collectives._needs_staging = lambda x, group: True
    ex = collectives._EXCHANGES[group]
    step, ex.STEP = ex.STEP, 16         # files grown in 16-byte steps
    try:
        staged = collectives.reduce_scatter(x, group, dim=1)
        gathered_last = collectives.all_gather(x, group, dim=-1)
        counts = dict(collectives.COUNTS)
        # a tensor twice as large: the exchange's files grow
        big = torch.cat([x, x + 100], dim=1)
        grown = (collectives.reduce_scatter(big, group, dim=1),
                 collectives.all_gather(big, group, dim=-1), ex.gen)
    finally:
        collectives._needs_staging = real
        ex.STEP = step
    w = (torch.arange(4.0).reshape(2, 2) + r).requires_grad_(True)
    y = collectives.gather_shards(w, group, 0)
    (torch.sum(y * torch.arange(8.0).reshape(4, 2)) * (r + 1)).backward()
    return {"plain": plain, "staged": staged, "counts": counts,
            "gathered_last": gathered_last, "grown": grown,
            "gathered": y.detach(), "grad": w.grad,
            "shm_prefix": world.shm_prefix}


# ---------------------------------------------------------------------------
# caches split by sequence, kv heads the ``model`` axis does not divide, and
# MoE routing groups split across ranks
# ---------------------------------------------------------------------------


def seq_serve(world, arch, overrides, mesh_kw, params_np, batch_np, teacher,
              max_len, shard_seq):
    """The reduced ``arch`` (``overrides`` applied, among them its
    participant granularity) served on the world of
    ``MeshConfig(**mesh_kw)`` from ``params_np``: a prefill of
    ``batch_np`` and one decode of each column of ``teacher``, served
    after a second cache, of a length no axis of 2 divides (whole along
    its sequence), was placed (a server serves the layout of the cache it
    is given, not of the last it placed); every step's last logits, the
    rank's cache leaves with their specs, the axes that split its
    sequence and its coordinates (the test slices one process's cache by
    them), the
    routes the MoE's layers took (``pos`` and ``keep`` of this rank's
    slots) and the collectives issued."""
    from repro_torch.core.distributed import Server
    from repro_torch.engine.flat import params_from_numpy
    from repro_torch.launch.mesh import make_mesh_from_config

    cfg = configs.reduced(configs.get_config(arch)).with_(**overrides)
    mcfg = MeshConfig(**mesh_kw)
    mesh = make_mesh_from_config(mcfg, "cpu")
    server = Server(cfg, mcfg, mesh=mesh, shard_seq=shard_seq, device="cpu")
    params = server.shard_params(params_from_numpy(params_np, "cpu"))
    B = teacher.shape[0]
    whole = server.model.init_cache(B, max_len, "cpu")
    spec = server.policy.cache_spec(whole, shard_seq=shard_seq, world=True)
    cache = server.shard_cache(whole)
    other = server.shard_cache(server.model.init_cache(B, 2 * max_len + 1,
                                                       "cpu"))
    assert other["seq_axes"]["k"] is None
    batch = {k: torch.as_tensor(v) for k, v in batch_np.items()}
    collectives.reset_counts()
    logits, cache = server.prefill(params, batch, cache)
    steps = [logits[:, -1]]
    for i in range(teacher.shape[1]):
        logits, cache = server.decode(
            params, torch.as_tensor(teacher[:, i:i + 1]), cache)
        steps.append(logits[:, -1])
    return {"steps": torch.stack(steps), "pos": cache["pos"],
            "seq_axes": cache["seq_axes"],
            "cache": {k: v for k, v in cache.items()
                      if isinstance(v, torch.Tensor)},
            "spec": {k: v for k, v in spec.items() if k != "pos"},
            "coords": mesh.coords, "counts": dict(collectives.COUNTS),
            "local": {k: tuple(v.shape) for k, v in params.get(
                "layers", {}).get("attn", {}).items()}}


def seq_serves_body(world, cases):
    """:func:`seq_serve` of every case (``{name: its arguments}``), one
    after another in one world."""
    return {name: seq_serve(world, *args) for name, args in cases.items()}


def kv_whole_grads(world, arch, overrides, mesh_kw, params_np, batch_np,
                   drop_sum=False):
    """The loss and every leaf's gradient (gathered by the state's specs,
    rank 0) of a reduced ``arch`` on the world of ``MeshConfig(**mesh_kw)``
    as a step computes them (``DistributedTrainer.grads``), with the local
    shapes of the attention's weights. ``drop_sum``: a control with the
    sum of the whole ``wk`` / ``wv``'s gradient over ``model`` left out
    (``layers._kv_whole_in`` made the identity in this rank)."""
    from repro_torch.core.distributed import DistributedTrainer
    from repro_torch.engine.flat import params_from_numpy
    from repro_torch.launch.mesh import make_mesh_from_config
    from repro_torch.models import layers as L
    from repro_torch.sharding import gather_tree

    cfg = configs.reduced(configs.get_config(arch)).with_(**overrides)
    mcfg = MeshConfig(**mesh_kw)
    mesh = make_mesh_from_config(mcfg, "cpu")
    real = L._kv_whole_in
    if drop_sum:
        L._kv_whole_in = lambda w: w
    try:
        trainer = DistributedTrainer(cfg, TrainConfig(optimizer="sgd",
                                                      lr=0.1), mcfg,
                                     mesh=mesh, device="cpu")
        state = trainer.shard_state(
            whole_state(trainer, params_from_numpy(params_np, "cpu")))
        batch = {k: torch.as_tensor(v) for k, v in batch_np.items()}
        loss, grads = trainer.grads(state, batch)
    finally:
        L._kv_whole_in = real
    specs = trainer.state_spec(trainer.abstract_state()).params
    whole = gather_tree(grads, specs, mesh)
    return {"loss": loss, "grads": whole if world.rank == 0 else None,
            "local": {k: tuple(v.shape[1:]) for k, v in
                      state.params["layers"]["attn"].items()}}


def seq_worlds_body(world, serves, grads):
    """The serves of ``serves`` (:func:`seq_serve`) and the gradients of
    ``grads`` (:func:`kv_whole_grads`), each ``{name: its arguments}``,
    in one world."""
    return {"serves": {n: seq_serve(world, *a) for n, a in serves.items()},
            "grads": {n: kv_whole_grads(world, *a) for n, a in grads.items()}}


def moe_rounds(world, arch, overrides, mesh_kw, params_np, batches, weights):
    """MoDeST rounds of a reduced ``arch`` (``overrides`` applied) on the
    world of ``MeshConfig(**mesh_kw)`` from ``params_np``: one round a
    batch of ``batches`` (``(P, E, B, S)`` leaves, a ``mask`` among them
    where given) with ``weights``, SGD at 0.1; each round's loss and the
    gathered parameters after it (rank 0)."""
    from repro_torch.core.distributed import DistributedTrainer
    from repro_torch.engine.flat import params_from_numpy
    from repro_torch.launch.mesh import make_mesh_from_config

    cfg = configs.reduced(configs.get_config(arch)).with_(**overrides)
    mcfg = MeshConfig(**mesh_kw)
    mesh = make_mesh_from_config(mcfg, "cpu")
    trainer = DistributedTrainer(cfg, TrainConfig(optimizer="sgd", lr=0.1),
                                 mcfg, strategy="modest", mesh=mesh,
                                 device="cpu")
    state = trainer.shard_state(
        whole_state(trainer, params_from_numpy(params_np, "cpu")))
    step = trainer.jit_train_step()
    losses, finals = [], []
    collectives.reset_counts()
    for b, w in zip(batches, weights):
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()},
                        torch.tensor(w, dtype=torch.float32))
        losses.append(float(m["loss"]))
        whole = trainer.gather_state(state).params     # every rank gathers
        finals.append(whole if world.rank == 0 else None)
    return {"losses": losses, "finals": finals,
            "counts": dict(collectives.COUNTS)}


def moe_groups_body(world, serves, rounds):
    """The serves of ``serves`` (:func:`seq_serve`, the routes recorded)
    and the rounds of ``rounds`` (:func:`moe_rounds`), each ``{name: its
    arguments}``, in one world. Every call of ``models.moe.routing`` is
    recorded: the ``pos`` and ``keep`` of this rank's slots (``keep``
    nonzero), in call order."""
    from repro_torch.models import moe

    real = moe.routing
    routes = []

    def recording(p, cfg, xg, span=None):
        r = real(p, cfg, xg, span)
        routes.append({"pos": r["pos"].clone(), "keep": r["keep"].clone(),
                       "every_keep": r.get("every_keep"),
                       "span": None if span is None else tuple(
                           span[1:])})
        return r

    moe.routing = recording
    try:
        out = {"serves": {}, "rounds": {}, "routes": {}}
        for name, args in serves.items():
            routes.clear()
            out["serves"][name] = seq_serve(world, *args)
            out["routes"][name] = list(routes)
        for name, args in rounds.items():
            out["rounds"][name] = moe_rounds(world, *args)
    finally:
        moe.routing = real
    return out
