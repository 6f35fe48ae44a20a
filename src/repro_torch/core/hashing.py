"""Deterministic hashing for sample derivation (Alg. 1, line 6).

The paper concatenates node identifier and round number and sorts the hashes
lexicographically; any collision-resistant hash works as long as *every node
uses the same one*, so we use sha256 (Python's builtin ``hash`` is
process-salted and would break cross-node consistency).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Sequence, Tuple


def stable_hash(token: str) -> bytes:
    return hashlib.sha256(token.encode("utf-8")).digest()


# (node id, round) -> digest memo. Every node in the population derives the
# same digests for the same round (that is the point of Alg. 1), so at
# n = 1000 the same (j, k) pair is hashed by hundreds of samplers per
# round; one shared memo turns that into one sha256 each. Bounded to a
# few MB: on overflow, entries from rounds already behind the requester
# are evicted first (they cannot recur except off-by-one round overlap),
# with a full reset as the fallback (e.g. a fresh session restarting at
# round 1 after a long one).
_DIGEST_MEMO: Dict[Tuple[str, int], bytes] = {}
_DIGEST_MEMO_MAX = 1 << 17


def _digest(j: str, round_k: int) -> bytes:
    key = (j, round_k)
    d = _DIGEST_MEMO.get(key)
    if d is None:
        if len(_DIGEST_MEMO) >= _DIGEST_MEMO_MAX:
            for stale in [s for s in _DIGEST_MEMO if s[1] < round_k - 1]:
                del _DIGEST_MEMO[stale]
            if len(_DIGEST_MEMO) >= _DIGEST_MEMO_MAX:
                _DIGEST_MEMO.clear()
        d = _DIGEST_MEMO[key] = stable_hash(f"{j}|{round_k}")
    return d


def sample_order(candidates: Iterable[str], round_k: int) -> List[str]:
    """Order candidates for round ``k`` by HASH(j + k), lexicographically.

    Deterministic given the candidate set: two nodes with identical views
    derive identical orders (=> identical samples); views differing in a few
    entries yield orders differing only around those entries (=> the
    *mostly-consistent* property, tested in tests/test_sampling.py).
    """
    return sorted(candidates, key=lambda j: _digest(j, round_k))


def select_sample(candidates: Sequence[str], round_k: int, s: int) -> List[str]:
    """First ``s`` of the hashed order — the *optimistic* sample before
    liveness pings (Alg. 1 pings these in parallel)."""
    return sample_order(candidates, round_k)[:s]


def select_aggregators(candidates: Sequence[str], round_k: int, a: int) -> List[str]:
    """Aggregators of round ``k`` = first ``a`` of the same order (§3.6)."""
    return sample_order(candidates, round_k)[:a]
