"""Shamir threshold secret sharing over GF(2^61 - 1).

Per-round mask secrets (32-bit ints, :func:`repro_torch.secureagg.prg.round_secret`)
are split into one share per cohort member; any ``t`` distinct shares
reconstruct the secret exactly, fewer reveal nothing about it (in the
information-theoretic sense — the *parameters* here are toy-sized, see
docs/SECUREAGG.md for the honest threat model).

Polynomial coefficients derive deterministically from the secret and the
(owner, round) label so a (seed, schedule) replay regenerates identical
shares — the DL001 contract. They are still unpredictable without the
secret itself, which is what hides the polynomial from share holders.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

from repro_torch.secureagg.prg import h64

PRIME = (1 << 61) - 1            # Mersenne prime; secrets are < 2^32 < P

Share = Tuple[int, int]          # (x, y) with 1 <= x, both mod PRIME


def split(secret: int, owner: str, round_k: int, n: int, t: int) -> Sequence[Share]:
    """``n`` shares of ``secret`` with threshold ``t`` (1-based x)."""
    if not 1 <= t <= n:
        raise ValueError(f"threshold {t} out of range for {n} shares")
    if not 0 <= secret < PRIME:
        raise ValueError("secret out of field range")
    coeffs = [secret] + [
        h64("modest-secagg-coeff", secret, owner, round_k, i) % PRIME
        for i in range(1, t)
    ]
    shares = []
    for x in range(1, n + 1):
        y = 0
        for c in reversed(coeffs):               # Horner, mod P
            y = (y * x + c) % PRIME
        shares.append((x, y))
    return shares


def reconstruct(shares: Iterable[Share], t: int) -> int:
    """Lagrange interpolation at 0 from >= ``t`` distinct shares."""
    pts: Dict[int, int] = {}
    for x, y in shares:
        pts[x] = y % PRIME
    if len(pts) < t:
        raise ValueError(f"need {t} distinct shares, have {len(pts)}")
    xs = sorted(pts)[:t]
    secret = 0
    for i, xi in enumerate(xs):
        num, den = 1, 1
        for j, xj in enumerate(xs):
            if i == j:
                continue
            num = (num * (-xj)) % PRIME
            den = (den * (xi - xj)) % PRIME
        secret = (secret + pts[xi] * num * pow(den, PRIME - 2, PRIME)) % PRIME
    return secret
