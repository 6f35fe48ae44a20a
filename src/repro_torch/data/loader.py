"""Per-client datasets and deterministic epoch/batch iteration."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class ClientDataset:
    x: np.ndarray
    y: np.ndarray

    def __len__(self):
        return len(self.x)

    def batches(self, batch_size: int, *, seed: int = 0, epochs: int = 1):
        """One pass (E epochs) over the local data, the paper's E=1 default."""
        rng = np.random.default_rng(seed)
        for _ in range(epochs):
            order = rng.permutation(len(self.x))
            for lo in range(0, len(order), batch_size):
                sel = order[lo:lo + batch_size]
                if len(sel) == 0:
                    continue
                yield self.x[sel], self.y[sel]

    def sample_batch(self, batch_size: int, *, seed: int = 0):
        rng = np.random.default_rng(seed)
        sel = rng.integers(0, len(self.x), size=min(batch_size, len(self.x)))
        return self.x[sel], self.y[sel]


@dataclass
class FederatedData:
    clients: List[ClientDataset]
    test: Optional[ClientDataset] = None
    task: str = "classification"

    @property
    def n_nodes(self):
        return len(self.clients)

    def pack_sample(self, client_ids, batch_size: int, *, seed: int = 0):
        """Gather one batch per sampled client, stacked with a leading
        participant axis — the host-side half of the mesh-form round
        (client sampling = which shards feed the participant slots)."""
        xs, ys = [], []
        for cid in client_ids:
            x, y = self.clients[cid].sample_batch(batch_size, seed=seed + cid)
            # pad short clients up to batch_size by repetition
            if len(x) < batch_size:
                reps = -(-batch_size // len(x))
                x = np.concatenate([x] * reps)[:batch_size]
                y = np.concatenate([y] * reps)[:batch_size]
            xs.append(x)
            ys.append(y)
        return np.stack(xs), np.stack(ys)
