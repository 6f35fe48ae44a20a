"""MoDeST protocol core — the paper's contribution.

* :mod:`repro_torch.core.hashing`   — deterministic sample-order hashing (Alg. 1, l.6)
* :mod:`repro_torch.core.registry`  — join/leave LWW registry (Alg. 2)
* :mod:`repro_torch.core.activity`  — unresponsive-node suppression (Alg. 3)
* :mod:`repro_torch.core.views`     — (C, E, N) views piggybacked on model transfers
* :mod:`repro_torch.core.sampling`  — mostly-consistent decentralized sampling (Alg. 1)
* :mod:`repro_torch.core.node`      — the full train/aggregate node (Alg. 4)
* :mod:`repro_torch.core.tasks`     — the learning-task interface and the byte-only task
* :mod:`repro_torch.core.distributed` — batched serving of the LMs (``Server``)
"""

from repro_torch.core.activity import ActivityTracker  # noqa: F401
from repro_torch.core.hashing import sample_order, stable_hash  # noqa: F401
from repro_torch.core.registry import Registry  # noqa: F401
from repro_torch.core.views import View  # noqa: F401
