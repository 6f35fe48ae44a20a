"""Fused flat-model compute engine.

Models live as single contiguous fp32 buffers inside the hot loop:

* :mod:`repro_torch.engine.flat`    — FlatSpec / FlatModel (pack once,
  unpack at task boundaries: eval, wire)
* :mod:`repro_torch.engine.cohort`  — batched cohort training (S·B
  per-node steps → B), its mesh-sharded aggregation (``MeshEngine``) +
  the sequential reference engine
* :mod:`repro_torch.engine.optim_flat` — row-wise optimizers on ``(S, N)``
* :mod:`repro_torch.engine.lowering`  — per-family masked-loss lowerings

Whole-model one-pass aggregation (one kernel launch per model, with a
fused aggregate→quantize variant) lives in :mod:`repro_torch.kernels.fused`
and is surfaced as :func:`repro_torch.kernels.aggregate_flatmodel`.
"""

from repro_torch.engine.cohort import (  # noqa: F401
    BatchedEngine,
    MeshEngine,
    SequentialEngine,
    make_engine,
)
from repro_torch.engine.flat import (  # noqa: F401
    FlatModel,
    FlatSpec,
    as_buffer,
    as_tree,
    params_from_numpy,
    params_to_numpy,
)
