"""Federated data pipeline: synthetic task generators, IID / non-IID
partitioning, and per-client batch loaders.

The LEAF / CIFAR / MovieLens datasets of the paper are not bundled with
the repository, so each task has a synthetic generator with the
same *shape* of heterogeneity (IID uniform split, Dirichlet label skew,
one-user-one-node), which is what the paper's claims depend on.
"""

from repro_torch.data.loader import ClientDataset, FederatedData  # noqa: F401
from repro_torch.data.partition import dirichlet_partition, iid_partition  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    make_classification_task,
    make_lm_task,
    make_mf_task,
)
