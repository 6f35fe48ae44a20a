"""repro_torch.serve — servable snapshots under query traffic
(docs/SERVE.md).

Round-k models published by a training session fan out to serving
replicas through ``Network.send``; replicas run saxml-style per-method
admission/batching queues and answer query load generated from the trace
fabric. Attach with ``ModestSession(..., serve=ServeConfig(...))`` (all
session drivers accept ``serve=``); the default ``serve=None`` is
zero-cost and golden-pinned byte-identical.
"""

from repro_torch.serve.config import SERVE_REGIMES, MethodConfig, ServeConfig
from repro_torch.serve.fabric import ServingFabric
from repro_torch.serve.replica import ServingReplica
from repro_torch.serve.traffic import QueryClient, RequestLoadDriver

__all__ = [
    "MethodConfig",
    "ServeConfig",
    "SERVE_REGIMES",
    "ServingFabric",
    "ServingReplica",
    "QueryClient",
    "RequestLoadDriver",
]
