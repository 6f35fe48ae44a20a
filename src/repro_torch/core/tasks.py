"""Learning-task abstraction bridging the protocol core and the model zoo.

A :class:`LearningTask` owns the model family: parameter init, the
local-SGD pass, aggregation (the hot spot — backed by the CUDA kernels via
``repro_torch.kernels.ops.aggregate_flatmodel``), evaluation, and a cost model that
gives the simulator a per-node training duration.

:class:`AbstractTask` carries byte-size-only payloads so protocol/network
experiments (Table 4) can run at the paper's published model sizes (346 KB …
6.7 MB) without doing the FLOPs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.data.loader import ClientDataset
from repro_torch.utils.pytree import tree_size_bytes, tree_weighted_mean


class LearningTask:
    """Interface; concrete tasks in ``repro_torch.models.tasks``."""

    name = "abstract"
    # Tasks that expose the FlatModel/cohort surface (flat_spec +
    # masked-batch training) opt in; the engine auto-selection in
    # ``repro_torch.engine.make_engine`` keys off this.
    supports_cohort = False

    def init_params(self, seed: int = 0):
        raise NotImplementedError

    def local_train(self, params, client: ClientDataset, *, batch_size: int,
                    epochs: int = 1, seed: int = 0, lr_scale: float = 1.0):
        raise NotImplementedError

    def evaluate(self, params, test: ClientDataset) -> dict:
        raise NotImplementedError

    def aggregate(self, models: Sequence, weights: Optional[Sequence[float]] = None):
        """AVG(Θ) — weighted model mean (Alg. 4 l.21).

        Zero-total weight raises (``tree_weighted_mean`` documents the
        contract shared by every aggregation path).
        """
        if weights is None:
            weights = [1.0] * len(models)
        return tree_weighted_mean(list(models), np.asarray(weights, np.float32))

    def evaluate_many(self, models: Sequence, test) -> list:
        """Evaluate several models; tasks with a stacked path override."""
        return [self.evaluate(p, test) for p in models]

    def aggregate_sequential(self, models: Sequence,
                             weights: Optional[Sequence[float]] = None):
        """The reference aggregation path (what ``engine="sequential"``
        runs). Defaults to :meth:`aggregate`; tasks that override
        ``aggregate`` with an engine path keep the legacy one here."""
        return self.aggregate(models, weights)

    _model_bytes_cache: Optional[int] = None

    def model_bytes(self, params=None) -> int:
        if params is not None:
            return tree_size_bytes(params)
        # Byte-only payload paths (crashed-trainer fallbacks, AbstractTask
        # sessions) call this once per message; materializing a fresh
        # parameter pytree each time is pure waste when only the wire size
        # matters, so the size is computed once per task instance.
        if self._model_bytes_cache is None:
            self._model_bytes_cache = tree_size_bytes(self.init_params(0))
        return self._model_bytes_cache

    def train_time(self, client: ClientDataset, *, batch_size: int,
                   epochs: int = 1, speed: float = 0.05) -> float:
        """Simulated seconds for E local epochs; ``speed`` = s/batch for
        this node (heterogeneous across nodes)."""
        n_batches = max(1, -(-len(client) // batch_size)) * epochs
        return n_batches * speed


class AbstractTask(LearningTask):
    """Size-only task for protocol/network experiments.

    ``params`` is a scalar round-counter ndarray; payloads carry
    ``model_bytes_`` on the wire.
    """

    name = "abstract"

    def __init__(self, model_bytes_: int, batches_per_client: int = 3):
        self._bytes = int(model_bytes_)
        self._batches = batches_per_client

    def init_params(self, seed: int = 0):
        return np.zeros((), np.float32)

    def local_train(self, params, client=None, *, batch_size: int = 20,
                    epochs: int = 1, seed: int = 0, lr_scale: float = 1.0):
        return params + 1.0

    def evaluate(self, params, test=None) -> dict:
        return {"rounds_seen": float(params)}

    def aggregate(self, models, weights=None):
        return np.mean([np.asarray(m) for m in models]).astype(np.float32)

    def model_bytes(self, params=None) -> int:
        return self._bytes

    def train_time(self, client=None, *, batch_size: int = 20, epochs: int = 1,
                   speed: float = 0.05) -> float:
        return self._batches * epochs * speed
