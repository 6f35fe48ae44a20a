"""Federated partitioning strategies (IID and Dirichlet label-skew)."""

from __future__ import annotations

import numpy as np


def iid_partition(n_samples: int, n_nodes: int, rng) -> list:
    """Uniform random equal split — the paper's CIFAR10 setting."""
    idx = rng.permutation(n_samples)
    return [np.sort(part) for part in np.array_split(idx, n_nodes)]


def dirichlet_partition(labels, n_nodes: int, alpha: float, rng,
                        min_per_node: int = 2) -> list:
    """Label-skew non-IID split: node j's class mix ~ Dir(alpha).

    Standard construction (Hsu et al. 2019) matching LEAF-style skew used
    for CelebA/FEMNIST in the paper.
    """
    labels = np.asarray(labels)
    classes = np.unique(labels)
    parts = [[] for _ in range(n_nodes)]
    for c in classes:
        idx = rng.permutation(np.where(labels == c)[0])
        props = rng.dirichlet([alpha] * n_nodes)
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for j, chunk in enumerate(np.split(idx, cuts)):
            parts[j].extend(chunk.tolist())
    # Re-balance pathological empty nodes by stealing from the largest.
    for j in range(n_nodes):
        while len(parts[j]) < min_per_node:
            donor = max(range(n_nodes), key=lambda m: len(parts[m]))
            parts[j].append(parts[donor].pop())
    return [np.sort(np.array(p, dtype=np.int64)) for p in parts]
