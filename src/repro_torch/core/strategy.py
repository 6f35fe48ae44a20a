"""Aggregation strategies of the mesh form of a round.

The protocol form of MoDeST moves models over UDP; the mesh form expresses
the *same math* on the participant axis of stacked replicas, so the three
algorithms compared in the paper are three different mixes:

* ``modest`` / ``fedavg`` — masked weighted mean over all participant
  replicas, broadcast back to every slot. The mask carries MoDeST's ``sf``
  semantics: failed or straggling slots get weight 0. ``fedavg`` differs
  only by an optional server optimizer (FedYogi/FedAdam, paper §5) applied
  to the aggregated pseudo-gradient.
* ``dsgd`` — one-peer exponential-graph pairwise averaging: slot p averages
  with slot (p + hop) mod P, the paper's D-SGD baseline.
* ``local`` — no mixing (ablation lower bound).

All strategies are pure functions on trees whose every leaf has a leading
participant axis P. On a mesh of distinct cards the reference lowers them
to an all-reduce and a collective-permute; here the P replicas lie stacked
on one device and the mixes are plain tensor products (``torch.tensordot``,
``torch.roll``), as the reference's ``jnp.tensordot`` is outside any
kernel of its own.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import optim
from repro_torch.config import TrainConfig
from repro_torch.utils.pytree import tree_map


class Strategy(NamedTuple):
    name: str
    init_state: Any          # (params_P=None) -> server-opt state (or ())
    mix: Any                 # (prev_P, new_P, weights, state, hop) -> (P-tree, state)


def _weighted_mean_bcast(trees_P, weights, agg_dtype=torch.float32):
    """Masked weighted mean over the leading P axis, broadcast back to P.

    ``agg_dtype`` sets the dtype of the cross-participant reduction (on a
    mesh, of the all-reduce on the wire: bfloat16 halves it). The weight
    w/Σw is applied *before* the reduction, so that bfloat16 stays in a
    well-conditioned range.
    """
    wn = _normalised(weights, agg_dtype)

    def leaf(x):
        avg = torch.tensordot(wn, x.to(agg_dtype), dims=([0], [0]))
        return avg[None].expand(x.shape).to(x.dtype)

    return tree_map(leaf, trees_P)


def _normalised(weights, agg_dtype):
    w = weights.to(torch.float32)
    return (w / torch.clamp_min(torch.sum(w), 1e-9)).to(agg_dtype)


def weighted_mean_share(weights, rows: slice, agg_dtype=torch.float32):
    """The share of :func:`_weighted_mean_bcast`'s mean that the replicas
    ``rows`` of the whole P axis hold, as a function of one leaf holding
    those rows: its weighted sum in ``agg_dtype``, returned in fp32 and
    without the P axis. Summed over shares that cover P it is the mean, in
    another summation order (a world's reduce form of the mix,
    ``DistributedTrainer.mix_form``)."""
    wn = _normalised(weights, agg_dtype)[rows]
    return lambda x: torch.tensordot(wn, x.to(agg_dtype),
                                     dims=([0], [0])).to(torch.float32)


def _mean_P(tree_P):
    return tree_map(lambda x: torch.mean(x.to(torch.float32), dim=0), tree_P)


def modest_strategy(tcfg: TrainConfig) -> Strategy:
    """MoDeST aggregation (also FedAvg's math when the weights are the
    server's sample mask). With ``server_optimizer`` other than ``avg`` /
    ``sgd`` the aggregators apply a FedYogi/FedAdam-style update to
    Δ = avg(θ_new) − θ_prev (paper §5)."""
    use_server_opt = tcfg.server_optimizer not in ("avg", "sgd")
    sopt = optim.build(tcfg, server=True) if use_server_opt else None
    agg_dtype = getattr(torch, tcfg.agg_dtype)

    def init_state(params_P=None):
        if not use_server_opt:
            return ()
        assert params_P is not None
        return sopt.init(_mean_P(params_P))

    def mix(prev_P, new_P, weights, state, hop=1):
        if not use_server_opt:
            return _weighted_mean_bcast(new_P, weights, agg_dtype), state
        w = weights.to(torch.float32)
        total = torch.clamp_min(torch.sum(w), 1e-9)
        prev_g = _mean_P(prev_P)                    # replicas equal pre-round
        avg = tree_map(
            lambda x: torch.tensordot(w, x.to(torch.float32),
                                      dims=([0], [0])) / total, new_P)
        # pseudo-gradient: the server descends on -(avg - prev)
        pseudo = tree_map(lambda a, p: -(a - p), avg, prev_g)
        upd, state = sopt.update(pseudo, state, prev_g)
        new_g = optim.apply_updates(prev_g, upd)
        out = tree_map(lambda g, x: g[None].expand(x.shape).to(x.dtype),
                       new_g, new_P)
        return out, state

    return Strategy("modest", init_state, mix)


def dsgd_strategy(tcfg: TrainConfig) -> Strategy:
    """One-peer exponential graph: slot p averages with slot
    (p + hop) mod P (``torch.roll`` by ``-hop`` on the participant axis;
    on a mesh, D-SGD's per-round neighbour exchange)."""

    def mix(prev_P, new_P, weights, state, hop=1):
        del prev_P, weights
        mixed = tree_map(
            lambda x: (0.5 * (x.to(torch.float32)
                              + torch.roll(x.to(torch.float32), -hop, dims=0))
                       ).to(x.dtype),
            new_P)
        return mixed, state

    return Strategy("dsgd", lambda params_P=None: (), mix)


def local_strategy(tcfg: TrainConfig) -> Strategy:
    def mix(prev_P, new_P, weights, state, hop=1):
        return new_P, state

    return Strategy("local", lambda params_P=None: (), mix)


def build_strategy(name: str, tcfg: TrainConfig) -> Strategy:
    if name in ("modest", "fedavg"):
        s = modest_strategy(tcfg)
        return Strategy(name, s.init_state, s.mix)
    if name == "dsgd":
        return dsgd_strategy(tcfg)
    if name == "local":
        return local_strategy(tcfg)
    raise ValueError(f"unknown strategy {name!r}")
