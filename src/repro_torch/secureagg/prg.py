"""Seeded primitives for secure aggregation: counter-based mask PRG and
a toy Diffie–Hellman key agreement.

Everything here is a pure function of its inputs — per-round secrets
derive from the session seed via SHA-256, so a (seed, schedule) pair
replays the identical trajectory (the DL001 contract). None of it is
cryptographically strong at these parameter sizes (32-bit DH group, a
statistical mixer as PRG); what the repo tests is the *protocol*
property — only masked bit patterns on the wire, threshold-gated
unmasking — not computational hardness. See docs/SECUREAGG.md.

The mask PRG is mirrored bit-exactly by the port's kernels: the plain
PyTorch version ``repro_torch.kernels.fused._plain_prg`` and the CUDA
device function ``prg_word`` of ``kernels/csrc/fused_agg.cu``; any change
here must change both — ``tests/test_torch_secureagg.py`` pins them against
each other and against the reference package's ``prg_word``.
"""

from __future__ import annotations

import hashlib

MASK32 = 0xFFFFFFFF
_MIX1 = 0x7FEB352D
_MIX2 = 0x846CA68B
_PERSONAL_TAG = 0x5EEDB0B5      # personal (self) mask seed derivation

# Toy DH group: largest 32-bit prime. pub_i = G^sk_i (mod P);
# s_ij = pub_j^sk_i = pub_i^sk_j = G^(sk_i·sk_j) — symmetric, and
# derivable from *one* endpoint's secret plus public keys only.
DH_PRIME = 4294967291           # 2**32 - 5
DH_GEN = 5


def mix32(x: int) -> int:
    """lowbias32-style avalanche on a 32-bit word (pure ints, wraps)."""
    x &= MASK32
    x = ((x ^ (x >> 16)) * _MIX1) & MASK32
    x = ((x ^ (x >> 15)) * _MIX2) & MASK32
    return (x ^ (x >> 16)) & MASK32


def prg_word(seed: int, ctr: int) -> int:
    """One uint32 mask word at counter ``ctr`` under ``seed``.

    Counter-based (not stateful): word l of a mask stream is a pure
    function of (seed, l), so kernels can generate any tile of the
    stream independently of tiling/sharding — the global lane index is
    the counter.
    """
    x = (ctr ^ ((seed * _MIX1) & MASK32)) & MASK32
    x = (mix32(x) + seed) & MASK32
    return mix32(x)


def h32(*parts) -> int:
    """32-bit integer digest of the parts (SHA-256, process-stable)."""
    raw = "|".join(str(p) for p in parts).encode()
    return int.from_bytes(hashlib.sha256(raw).digest()[:4], "big")


def h64(*parts) -> int:
    raw = "|".join(str(p) for p in parts).encode()
    return int.from_bytes(hashlib.sha256(raw).digest()[:8], "big")


def round_secret(master_seed: int, node_id: str, round_k: int) -> int:
    """Per-round DH secret sk_i^k in [1, P-2].

    Modelled PKI: in a deployment each node draws sk fresh and gossips
    pub; here both derive from the session seed so trajectories replay.
    """
    return 1 + h32("modest-secagg-sk", master_seed, node_id, round_k) % (DH_PRIME - 2)


def public_key(sk: int) -> int:
    return pow(DH_GEN, sk, DH_PRIME)


def pair_seed(sk_own: int, pub_other: int) -> int:
    """Mask seed for the (own, other) pair: hash of the DH agreement.

    Symmetric (g^{ab}), and — key to dropout resilience — computable
    from a *single* secret plus public keys: reconstructing sk_i alone
    authorizes deriving every pair seed of node i's mask.
    """
    return mix32(pow(pub_other, sk_own, DH_PRIME) & MASK32)


def personal_seed(sk: int) -> int:
    """Self-mask seed (Bonawitz's b_i): keeps a row non-plaintext even
    in a cohort of one, where no pairwise terms exist."""
    return mix32((sk ^ _PERSONAL_TAG) & MASK32)
