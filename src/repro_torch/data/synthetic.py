"""Synthetic learning tasks.

Each ``make_*_task`` returns ``(FederatedData, eval_fn_inputs)`` where the
federated data is already partitioned over ``n_nodes`` clients and a held-out
global test set is attached — mirroring the paper's setup of a global test
set available at every node (§4.2).
"""

from __future__ import annotations

import numpy as np

from repro_torch.data.loader import ClientDataset, FederatedData
from repro_torch.data.partition import dirichlet_partition, iid_partition


def make_classification_task(n_nodes: int, *, samples_per_node: int = 64,
                             image=(32, 32, 3), classes: int = 10,
                             iid: bool = True, alpha: float = 0.3,
                             test_size: int = 512, seed: int = 0) -> FederatedData:
    """Gaussian-cluster image classification (stand-in for CIFAR10/FEMNIST).

    Class c has a random mean image; samples are mean + noise. Linearly
    separable enough for a small CNN to make steady progress, hard enough
    that averaging/topology effects are visible.
    """
    rng = np.random.default_rng(seed)
    n_total = n_nodes * samples_per_node
    means = rng.normal(0, 1.0, size=(classes,) + tuple(image)).astype(np.float32)
    labels = rng.integers(0, classes, size=n_total)
    x = means[labels] + rng.normal(0, 2.0, size=(n_total,) + tuple(image)).astype(np.float32)
    if iid:
        parts = iid_partition(n_total, n_nodes, rng)
    else:
        parts = dirichlet_partition(labels, n_nodes, alpha, rng)
    clients = [ClientDataset(x[idx], labels[idx]) for idx in parts]

    tl = rng.integers(0, classes, size=test_size)
    tx = means[tl] + rng.normal(0, 2.0, size=(test_size,) + tuple(image)).astype(np.float32)
    return FederatedData(clients=clients, test=ClientDataset(tx, tl), task="classification")


def make_lm_task(n_nodes: int, *, samples_per_node: int = 32, seq_len: int = 128,
                 vocab: int = 512, iid: bool = True, alpha: float = 0.3,
                 test_size: int = 64, seed: int = 0) -> FederatedData:
    """Markov-chain language modelling (stand-in for next-word prediction).

    A global bigram transition table generates sequences; non-IID mode gives
    each client a preferred start-state region (label skew analogue).
    """
    rng = np.random.default_rng(seed)
    # Sparse-ish random bigram table with a few likely successors per token.
    succ = rng.integers(0, vocab, size=(vocab, 4))

    def gen(n, start_lo=0, start_hi=vocab):
        out = np.empty((n, seq_len), dtype=np.int32)
        state = rng.integers(start_lo, start_hi, size=n)
        for t in range(seq_len):
            out[:, t] = state
            choice = rng.integers(0, 4, size=n)
            jump = rng.random(n) < 0.05  # 5% random restarts
            state = np.where(jump, rng.integers(0, vocab, size=n),
                             succ[state, choice])
        return out

    clients = []
    for i in range(n_nodes):
        if iid:
            toks = gen(samples_per_node)
        else:
            lo = (i * vocab // n_nodes)
            hi = min(vocab, lo + max(vocab // max(n_nodes // 4, 1), 8))
            toks = gen(samples_per_node, lo, hi)
        clients.append(ClientDataset(toks[:, :-1], toks[:, 1:]))
    test = gen(test_size)
    return FederatedData(clients=clients,
                         test=ClientDataset(test[:, :-1], test[:, 1:]),
                         task="lm")


def make_mf_task(n_users: int, n_items: int, dim: int = 20, *,
                 ratings_per_user: int = 40, test_per_user: int = 5,
                 seed: int = 0) -> FederatedData:
    """Matrix-factorization ratings, one-user-one-node (paper MovieLens setup)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(0, 0.5, size=(n_users, dim)).astype(np.float32)
    v = rng.normal(0, 0.5, size=(n_items, dim)).astype(np.float32)
    clients, tests_x, tests_y = [], [], []
    for i in range(n_users):
        items = rng.choice(n_items, size=ratings_per_user + test_per_user, replace=False)
        r = (u[i] @ v[items].T + 3.0 + rng.normal(0, 0.1, size=items.shape)).astype(np.float32)
        r = np.clip(r, 1.0, 5.0)
        pairs = np.stack([np.full_like(items, i), items], axis=1).astype(np.int32)
        clients.append(ClientDataset(pairs[:ratings_per_user], r[:ratings_per_user]))
        tests_x.append(pairs[ratings_per_user:])
        tests_y.append(r[ratings_per_user:])
    test = ClientDataset(np.concatenate(tests_x), np.concatenate(tests_y))
    return FederatedData(clients=clients, test=test, task="mf")
