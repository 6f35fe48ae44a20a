"""MoE routing groups split across ranks (``models.moe.routing`` with a
``Span``): each rank routes its own tokens, gathers their expert choices
over the rows' axis and rebuilds one process's slots in every group it
touches.

* Without a world: a grid of token counts, rank counts, group sizes,
  capacity factors and top k, with padding. The ranks run one after
  another in one process, their collectives answered from every rank's
  inputs of the pass before, until a pass changes nothing. Each rank's
  own slots' ``pos`` and ``keep`` and its tokens' ``gates`` equal one
  process's bit for bit, the load-balance loss is within 1e-6 and the
  outputs within 1e-5.
* A 2 x 1 world serving the reduced qwen3-moe: a decode batch of 16 whose
  single group (16 tokens, capacity 10) splits 8 a rank and drops slots,
  and a prefill of 2 x 12 tokens that splits a group of 16, padding
  included.
* A 2 x 2 world, the reduced arctic-480b at ``pod`` granularity (FSDP):
  rounds whose rank rows split groups (4 x 6 tokens a participant, 12 a
  rank, groups of 16), and a masked batch with unequal valid counts on
  the two ``data`` ranks; and at ``chip`` granularity with a capacity
  factor of 0.5, a serve whose rank rows split a group that drops slots.

Against the port's one process and the reference's, from
``jax.random.key(0)``'s weights. Tolerances: ``rtol = atol = 1e-5``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world_bodies as bodies
from repro import configs as jconfigs
from repro.config import MeshConfig as JMeshConfig
from repro.config import TrainConfig as JTrainConfig
from repro.core.distributed import DistributedTrainer as JTrainer
from repro.models import build as jbuild
from repro_torch import collectives, configs
from repro_torch.config import MeshConfig, TrainConfig
from repro_torch.core.distributed import DistributedTrainer, Server
from repro_torch.engine.flat import params_from_numpy
from repro_torch.launch.world import run_world
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.utils.pytree import tree_leaves
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
WORLD = dict(device="cpu", threads=1, quiet=True, timeout=170.0)
QWEN, ARCTIC = "qwen3-moe-30b-a3b", "arctic-480b"


def _cfgs(arch, **kw):
    return (jconfigs.reduced(jconfigs.get_config(arch)).with_(**kw),
            configs.reduced(configs.get_config(arch)).with_(**kw))


# ---------------------------------------------------------------------------
# the ranks' routing, without a world
# ---------------------------------------------------------------------------


def _simulate(n, run, passes=8):
    """``[run(r) for r in range(n)]`` under ``layers.split_rows`` of a
    stand-in mesh of ``n`` ranks (``means``: training's), each rank's
    ``all_gather`` / ``all_reduce`` answered from every rank's inputs to
    the same call in the pass before (its own until then), pass after pass
    until no rank's inputs change: then every answer is the world's."""
    prev, outs = None, None
    real = collectives.all_gather, collectives.all_reduce
    for _ in range(passes):
        cur = [[] for _ in range(n)]

        def known(r, i):
            return prev is not None and all(len(p) > i for p in prev)

        def run_rank(r):
            def gather(t, group, dim=0):
                i = len(cur[r])
                cur[r].append(t.clone())
                if not known(r, i):
                    return torch.cat([t] * n, dim=dim)
                return torch.cat([prev[j][i] for j in range(n)], dim=dim)

            def reduce(t, group, op="sum"):
                i = len(cur[r])
                cur[r].append(t.clone())
                if known(r, i):
                    t.copy_(sum(prev[j][i] for j in range(n)))
                return t

            mesh = types.SimpleNamespace(
                in_world=True, group=lambda a: "rows",
                axis_index=lambda a: r, axis_size=lambda a: n)
            collectives.all_gather, collectives.all_reduce = gather, reduce
            try:
                with L.split_rows(mesh, "data", means=True):
                    return run(r)
            finally:
                collectives.all_gather, collectives.all_reduce = real

        outs = [run_rank(r) for r in range(n)]
        if prev is not None and all(
                len(a) == len(b) and all(torch.equal(x, y)
                                         for x, y in zip(a, b))
                for a, b in zip(cur, prev)):
            return outs
        prev = cur
    raise AssertionError("the ranks' collectives did not settle")


def _recorded(fn):
    """``fn()`` with every ``moe.routing`` call's result recorded."""
    real, seen = moe.routing, []

    def rec(p, cfg, xg, span=None):
        r = real(p, cfg, xg, span)
        seen.append((r, span))
        return r

    moe.routing = rec
    try:
        return fn(), seen
    finally:
        moe.routing = real


# (ranks, tokens a rank, group size, capacity factor, top k)
GRID = [(2, 12, 16, 1.25, 2), (2, 12, 16, 0.5, 2), (4, 6, 16, 0.5, 2),
        (3, 10, 8, 0.5, 1), (4, 5, 4, 1.0, 2), (3, 7, 16, 0.5, 1),
        (4, 3, 16, 0.5, 2), (2, 9, 4, 0.5, 2), (2, 16, 16, 0.5, 2),
        (4, 8, 8, 1.25, 1)]


@pytest.mark.parametrize("n,t,G,cf,k", GRID)
def test_split_routing_equals_one_process(n, t, G, cf, k):
    _, cfg = _cfgs(QWEN, moe_group_size=G, moe_capacity_factor=cf,
                   moe_top_k=k)
    p = {kk: v[0] for kk, v in build_layer(cfg).items()}
    N = n * t
    x = torch.from_numpy(np.random.default_rng(N + G).standard_normal(
        (1, N, cfg.d_model)).astype(np.float32))
    (one_out, one_aux), one = _recorded(lambda: moe.moe_ffn(p, cfg, x))
    (r1,) = [r for r, _ in one]

    def rank(r):
        return _recorded(lambda: moe.moe_ffn(p, cfg, x[:, r * t:(r + 1)
                                                        * t]))

    outs = _simulate(n, rank)
    dropped = bool((r1["keep"] == 0).any())
    split = False
    for r, ((out, aux), seen) in enumerate(outs):
        (got, span), = seen
        split |= span is not None
        lo = 0 if span is None else span.off
        a = r * t
        pos = got["pos"].reshape(-1)[lo * k:(lo + t) * k]
        keep = got["keep"].reshape(-1)[lo * k:(lo + t) * k]
        assert torch.equal(pos, r1["pos"].reshape(-1)[a * k:(a + t) * k])
        assert torch.equal(keep, r1["keep"].reshape(-1)[a * k:(a + t) * k])
        gates = got["gates"].reshape(-1, k)[lo:lo + t]
        assert torch.equal(gates, r1["gates"].reshape(-1, k)[a:a + t])
        if span is not None:            # no other rank's slot is kept here
            assert float(got["keep"].sum()) == float(keep.sum())
        np.testing.assert_allclose(float(aux), float(one_aux), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(out.numpy(),
                                   one_out[:, a:a + t].numpy(), **TOL)
    # the grid's groups split across ranks except where a rank's tokens
    # fill whole groups (then they route alone)
    assert split == (t % min(G, N) != 0 or min(G, t) != min(G, N))
    if (n, t, G, cf) == (2, 12, 16, 0.5):
        assert dropped


def build_layer(cfg):
    """One MoE layer's parameters (a stack of one) drawn from a seed."""
    cfg1 = dataclasses.replace(cfg, n_layers=1)
    return moe.init(torch.Generator().manual_seed(0), cfg1,
                    "cpu")["layers"]["moe"]


# ---------------------------------------------------------------------------
# worlds
# ---------------------------------------------------------------------------

# name: (arch, overrides, mesh, batch rows, prompt, decodes, max_len)
SERVES = {
    "decode16": (QWEN, {}, dict(data=2, model=1), 16, 4, 3, 16),
    "prefill2x12": (QWEN, {}, dict(data=2, model=1), 2, 12, 3, 24),
    "arctic-chip": (ARCTIC, dict(participant_granularity="chip",
                                 moe_capacity_factor=0.5),
                    dict(data=2, model=2), 4, 6, 2, 16),
}
ROUND_MESH = dict(data=2, model=2)
POD = dict(participant_granularity="pod")


def _one_serve(cfg, params_np, tokens, new, max_len):
    server = Server(cfg, device="cpu")
    params = params_from_numpy(params_np, "cpu")
    cache = server.model.init_cache(tokens.shape[0], max_len, "cpu")
    (logits, cache), seen = _recorded(lambda: server.prefill(
        params, {"tokens": torch.as_tensor(tokens)}, cache))
    steps, toks, routes = [logits[:, -1]], [], [seen]
    for _ in range(new):
        tok = torch.argmax(logits[:, -1:], dim=-1)
        toks.append(tok)
        (logits, cache), seen = _recorded(
            lambda: server.decode(params, tok, cache))
        steps.append(logits[:, -1])
        routes.append(seen)
    return torch.cat(toks, dim=1).numpy(), torch.stack(steps), routes


def _ref_serve(jcfg, params_np, tokens, teacher, max_len):
    model = jbuild(jcfg)
    params = jax.tree.map(jnp.asarray, params_np)
    cache = model.init_cache(tokens.shape[0], max_len)
    logits, cache = model.prefill(params, {"tokens": jnp.asarray(tokens)},
                                  cache)
    steps = [np.asarray(logits[:, -1])]
    for i in range(teacher.shape[1]):
        logits, cache = model.decode_step(
            params, jnp.asarray(teacher[:, i:i + 1], jnp.int32), cache)
        steps.append(np.asarray(logits[:, -1]))
    return np.stack(steps)


def _batches(cfg):
    """Two rounds of 4 x 6 tokens a participant (P = 1) and a masked
    third: the first data rank's rows keep 11 of 12 tokens, the second's
    2."""
    rng = np.random.default_rng(4)
    out = []
    for i in range(3):
        toks = rng.integers(0, cfg.vocab, (1, 1, 4, 6))
        b = {"tokens": toks, "labels": np.roll(toks, -1, axis=-1)}
        if i == 2:
            mask = np.zeros((1, 1, 4, 6), np.float32)
            mask[..., 0, :] = mask[..., 1, :5] = 1.0
            mask[..., 2:, 0] = 1.0
            b["mask"] = mask
        out.append(b)
    return out


@pytest.fixture(scope="module")
def cases():
    serves = {}
    for name, (arch, kw, mesh, rows, S, new, max_len) in SERVES.items():
        jcfg, cfg = _cfgs(arch, **kw)
        params_np = jax.tree.map(np.asarray,
                                 jbuild(jcfg).init(jax.random.key(0)))
        tokens = np.random.default_rng(rows * S).integers(
            0, cfg.vocab, (rows, S))
        toks, steps, routes = _one_serve(cfg, params_np, tokens, new,
                                         max_len)
        serves[name] = dict(
            args=(arch, kw, mesh, params_np, {"tokens": tokens}, toks,
                  max_len, False),
            steps=steps, routes=routes,
            ref=_ref_serve(jcfg, params_np, tokens, toks, max_len))
    jcfg, cfg = _cfgs(ARCTIC, **POD)
    jtr = JTrainer(jcfg, JTrainConfig(optimizer="sgd", lr=0.1),
                   JMeshConfig(**ROUND_MESH), strategy="modest")
    jstate = jtr.init_state(0)
    init = jax.tree.map(lambda x: np.asarray(x[0]), jstate.params)
    batches = _batches(cfg)
    weights = [[1.0]] * len(batches)
    jstep = jax.jit(jtr.build_train_step())
    tr = DistributedTrainer(cfg, TrainConfig(optimizer="sgd", lr=0.1),
                            MeshConfig(**ROUND_MESH), strategy="modest",
                            device="cpu")
    state = bodies.whole_state(tr, params_from_numpy(init, "cpu"))
    step = tr.jit_train_step()
    ref, one = [], []
    for b, w in zip(batches, weights):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                           jnp.asarray(w, jnp.float32))
        ref.append((float(jm["loss"]),
                    jax.tree.map(np.asarray, jstate.params)))
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()},
                        torch.tensor(w, dtype=torch.float32))
        one.append((float(m["loss"]), state.params))
    rounds = dict(args=(ARCTIC, POD, ROUND_MESH, init, batches, weights),
                  ref=ref, one=one)
    return serves, rounds


@pytest.fixture(scope="module")
def worlds(cases):
    serves, rounds = cases
    two = {n: c["args"] for n, c in serves.items() if c["args"][2]["model"]
           == 1}
    four = {n: c["args"] for n, c in serves.items()
            if c["args"][2]["model"] == 2}
    return {2: run_world(bodies.moe_groups_body, 2, args=(two, {}), **WORLD),
            4: run_world(bodies.moe_groups_body, 4,
                         args=(four, {"arctic-pod": rounds["args"]}),
                         **WORLD)}


@pytest.mark.parametrize("name", list(SERVES))
def test_split_groups_serve_equals_one_process_and_reference(cases, worlds,
                                                             name):
    case = cases[0][name]
    np.testing.assert_allclose(case["steps"].numpy(), case["ref"], **TOL)
    ranks = worlds[2 if case["args"][2]["model"] == 1 else 4]
    for r in ranks:
        np.testing.assert_allclose(r["serves"][name]["steps"].numpy(),
                                   case["steps"].numpy(), **TOL)
    routes = ranks[0]["routes"][name]
    spans = [s for s in (rt["span"] for rt in routes) if s is not None]
    assert spans                               # some call split a group
    if name == "decode16":
        # every decode routes 16 tokens in one group of capacity 10,
        # 8 a rank; one process drops slots in some step
        one_routes = [r for step in case["routes"][1:] for r, _ in step]
        assert all(r["C"] == 10 and r["pos"].shape == (1, 32)
                   for r in one_routes)
        assert any(bool((r["keep"] == 0).any()) for r in one_routes)
        # the ranks' own slots are one process's, bit for bit
        n_layers = len(case["routes"][1])
        for step in range(1, len(case["routes"])):
            for layer in range(n_layers):
                want = case["routes"][step][layer][0]
                for rank, r in enumerate(ranks):
                    got = r["routes"][name][len(case["routes"][0])
                                            + (step - 1) * n_layers + layer]
                    own = slice(rank * 16, (rank + 1) * 16)
                    assert torch.equal(got["pos"][0, own],
                                       want["pos"][0, own])
                    assert torch.equal(got["keep"][0, own],
                                       want["keep"][0, own])
                    assert torch.equal(got["every_keep"], want["keep"])


def test_split_groups_rounds_equal_one_process_and_reference(cases, worlds):
    """arctic at ``pod`` granularity on 2 x 2: two rounds whose rank rows
    split a routing group (12 tokens a rank, groups of 16), then a masked
    round with 11 and 2 valid tokens on the two ``data`` ranks."""
    rounds = cases[1]
    got = [r["rounds"]["arctic-pod"] for r in worlds[4]]
    for i, ((ref_loss, ref_params), (one_loss, one_params)) in enumerate(
            zip(rounds["ref"], rounds["one"])):
        np.testing.assert_allclose(one_loss, ref_loss, **TOL)
        for r in got:
            np.testing.assert_allclose(r["losses"][i], one_loss, **TOL)
        for g, o, w in zip(tree_leaves(got[0]["finals"][i]),
                           tree_leaves(one_params),
                           tree_leaves(ref_params)):
            np.testing.assert_allclose(g.numpy(), o.numpy(), **TOL)
            np.testing.assert_allclose(o.numpy(), w, **TOL)
    # the masked round's ranks saw unequal counts, and its loss is the
    # participant's mean over its 13 valid tokens, not the ranks' mean
    mask = rounds["args"][4][2]["mask"]
    assert mask[..., :2, :].sum() == 11 and mask[..., 2:, :].sum() == 2
    assert got[0]["counts"]["all_gather"] > 0
