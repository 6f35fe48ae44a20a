"""Pairwise masking of model payloads (the trainer/aggregator halves).

A trainer in cohort ``roster`` for round ``k`` seals its update before
pushing: the flat fp32 buffer's *bit patterns* are shifted additively in
the uint32 ring by a per-node mask

    M_i[l] = PRG(b_i, l) + sum_{j in roster, j != i} sign(i,j) * PRG(s_ij, l)

with ``b_i`` a personal seed and ``s_ij`` the DH pair seed — both
derivable from node i's per-round secret ``sk_i`` plus public keys only.
The aggregator, once authorized by >= t Shamir shares per *arrived*
sender, reconstructs those senders' secrets, regenerates the masks
in-kernel and removes them exactly (ring subtraction), then runs the
identical plain aggregate->quantize math — so the masked fused path is
bit-identical to the plain kernels. Dropped senders' secrets are never
reconstructed; their rows simply never existed. See docs/SECUREAGG.md
for the full protocol and the honest threat model.

Ring masking of bit patterns (not fp addition) is what makes the exact
unmask possible: fp addition is non-associative, so any construction
that only recovers a masked *sum* could never be bit-identical to the
plain kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.fused import apply_mask_flat
from repro_torch.secureagg import prg, shamir

MOD32 = 1 << 32


def _mask_args(seeds, signs, device):
    """A mask row's seeds and signs as int64 tensors on the buffer's
    device, moved there in one copy: a seed up to 2^32 - 1 is held in int64
    (``torch.uint32`` has thin operator coverage); the kernels read it
    modulo 2^32."""
    both = torch.tensor([seeds, signs], dtype=torch.int64, device=device)
    return both[0], both[1]


def threshold(roster_size: int) -> int:
    """t = ceil(s/2) + 1 — a strict majority plus one must survive
    (clamped to the roster size for degenerate 1- and 2-node cohorts)."""
    return min(roster_size, math.ceil(roster_size / 2) + 1)


@dataclass(eq=False)
class SealedModel:
    """A masked model payload — the only params representation that ever
    leaves a trainer when ``ModestConfig.secure_agg`` is on.

    ``payload`` is a FlatModel whose buffer holds masked bit patterns
    (kind="flat"), a single masked uint32 word (kind="scalar", the
    AbstractTask round-counter path), or ``None`` (kind="bytes" — the
    size-only protocol experiments, where sealing still runs the full
    share/threshold machinery but there are no parameter bits to hide).
    ``nbytes`` is the plain wire size: masking is size-preserving.
    """

    kind: str
    payload: object
    sender: str
    round_k: int
    roster: Tuple[str, ...]
    nbytes: int


class PairwiseMasker:
    """Derives per-round secrets, seeds, shares and (un)masks payloads.

    One instance per node, seeded from the session seed: every value it
    produces is a pure function of (seed, node, round) — the DL001
    replay contract. The public-key directory is modelled (any party
    can derive ``public(j)``), standing in for the PKI Bonawitz et al.
    assume; secrets are only ever *used* by their owner or after
    threshold-gated Shamir reconstruction.
    """

    def __init__(self, master_seed: int):
        self.master_seed = int(master_seed)
        self._secrets: Dict[Tuple[str, int], int] = {}
        self._publics: Dict[Tuple[str, int], int] = {}

    # ------------------------------------------------------------- key mgmt

    def secret(self, node_id: str, round_k: int) -> int:
        key = (node_id, round_k)
        if key not in self._secrets:
            if len(self._secrets) > 4096:       # bounded per-round cache
                self._secrets.clear()
            self._secrets[key] = prg.round_secret(self.master_seed, node_id,
                                                  round_k)
        return self._secrets[key]

    def public(self, node_id: str, round_k: int) -> int:
        key = (node_id, round_k)
        if key not in self._publics:
            if len(self._publics) > 4096:
                self._publics.clear()
            self._publics[key] = prg.public_key(self.secret(node_id, round_k))
        return self._publics[key]

    def seeds_row(self, sk: int, sender: str, round_k: int,
                  roster: Sequence[str]) -> Tuple[List[int], List[int]]:
        """(seeds, signs) over the roster for ``sender``'s mask, derived
        from ``sk`` (the caller either owns it or reconstructed it)."""
        seeds, signs = [], []
        for j in roster:
            if j == sender:
                seeds.append(prg.personal_seed(sk))
                signs.append(1)
            else:
                seeds.append(prg.pair_seed(sk, self.public(j, round_k)))
                signs.append(1 if sender < j else -1)
        return seeds, signs

    # ------------------------------------------------------------- sealing

    def seal(self, params, sender: str, round_k: int,
             roster: Sequence[str], nbytes: int) -> SealedModel:
        roster = tuple(roster)
        if params is None:
            return SealedModel(kind="bytes", payload=None, sender=sender,
                               round_k=round_k, roster=roster, nbytes=nbytes)
        sk = self.secret(sender, round_k)
        seeds, signs = self.seeds_row(sk, sender, round_k, roster)
        if hasattr(params, "buffer") and hasattr(params, "spec"):
            masked = apply_mask_flat(
                params.buffer, *_mask_args(seeds, signs, params.buffer.device))
            payload = type(params)(masked, params.spec)
            kind = "flat"
        else:
            word = self._scalar_word(seeds, signs)
            bits = int(np.asarray(params, np.float32).view(np.uint32))
            payload = (bits + word) % MOD32
            kind = "scalar"
        return SealedModel(kind=kind, payload=payload, sender=sender,
                           round_k=round_k, roster=roster, nbytes=nbytes)

    @staticmethod
    def _scalar_word(seeds: Sequence[int], signs: Sequence[int]) -> int:
        word = 0
        for s, sg in zip(seeds, signs):
            word = (word + sg * prg.prg_word(s, 0)) % MOD32
        return word

    def unseal_scalar(self, sealed: SealedModel, sk: int) -> np.ndarray:
        seeds, signs = self.seeds_row(sk, sealed.sender, sealed.round_k,
                                      sealed.roster)
        word = self._scalar_word(seeds, signs)
        bits = (sealed.payload - word) % MOD32
        return np.uint32(bits).view(np.float32).reshape(())

    def unseal_flat(self, sealed: SealedModel, sk: int):
        """Exact per-row unmask outside the fused kernel (mixed-payload
        fallback; the hot path is the fused unmask-aggregate kernel)."""
        seeds, signs = self.seeds_row(sk, sealed.sender, sealed.round_k,
                                      sealed.roster)
        fm = sealed.payload
        buf = apply_mask_flat(fm.buffer, *_mask_args(
            seeds, [-s for s in signs], fm.buffer.device))
        return type(fm)(buf, fm.spec)

    def unmask_matrices(self, sealed_models: Sequence[SealedModel],
                        secrets: Dict[str, int]):
        """Per-row (seeds, signs) matrices for the fused unmask kernel:
        row i regenerates sender i's mask from its reconstructed secret."""
        seeds_m, signs_m = [], []
        for sm in sealed_models:
            seeds, signs = self.seeds_row(secrets[sm.sender], sm.sender,
                                          sm.round_k, sm.roster)
            seeds_m.append(seeds)
            signs_m.append(signs)
        return (np.asarray(seeds_m, np.uint32), np.asarray(signs_m, np.int32))

    # ------------------------------------------------------------- sharing

    def make_shares(self, owner: str, round_k: int,
                    roster: Sequence[str]) -> Dict[str, shamir.Share]:
        """One share of ``owner``'s round secret per roster member
        (share x = 1-based roster position, so any subset reconstructs)."""
        roster = tuple(roster)
        t = threshold(len(roster))
        sk = self.secret(owner, round_k)
        shares = shamir.split(sk, owner, round_k, len(roster), t)
        return dict(zip(roster, shares))

    @staticmethod
    def reconstruct(shares: Sequence[shamir.Share], t: int) -> int:
        return shamir.reconstruct(shares, t)
