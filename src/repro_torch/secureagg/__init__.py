"""Dropout-resilient secure aggregation for the MoDeST cohort path.

Pairwise-mask aggregation in the Bonawitz et al. mould, adapted to the
per-row-exact-unmask construction that keeps the fused agg->quantize
kernel bit-identical to the plain path (docs/SECUREAGG.md):

* :mod:`repro_torch.secureagg.prg`    — counter-based uint32 PRG + toy DH key
  agreement (mirrored bit-exactly by the CUDA kernels).
* :mod:`repro_torch.secureagg.shamir` — threshold secret sharing of per-round
  mask secrets over a 61-bit prime field.
* :mod:`repro_torch.secureagg.masking`— :class:`PairwiseMasker` (seal/unseal,
  share split/reconstruct, kernel seed matrices) and
  :class:`SealedModel`, the only model representation that ever leaves
  a trainer when ``ModestConfig.secure_agg`` is on.
"""

from repro_torch.secureagg.masking import PairwiseMasker, SealedModel, threshold

__all__ = ["PairwiseMasker", "SealedModel", "threshold"]
