"""Serving configuration: per-method admission/batching knobs + deployment.

The shape follows saxml's servable-model metadata: a deployment exposes
named *methods*, each with its own max batch size, queue depth and
deadline; a replica runs one admission/batching queue per method
(``repro_torch.serve.replica``). Query arrival load is generated from the trace
fabric — an availability profile re-interpreted as *request* intensity
(``repro_torch.serve.traffic``, docs/SERVE.md).

``ServeConfig`` is attached to a session as ``serve=``; the default is
``None`` and the zero-cost contract of the fault fabric applies: with no
config attached, no replica/client objects exist, no events are
scheduled, no RNG is consumed, and the golden trajectories stay
byte-identical (pinned in ``tests/test_determinism.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.traces import flash_crowd_profile


@dataclass(frozen=True)
class MethodConfig:
    """One servable method (saxml ``servable_model.py`` style).

    Serve cost is expressed in units of the *host node's* speed (seconds
    per training batch), so a replica co-located with a slow edge node
    answers slowly — heterogeneity applies to the query plane too:
    ``batch_duration = speed * (cost_base + cost_per_item * batch)``.
    """

    name: str = "predict"
    max_batch: int = 8              # per-method max batch size
    max_queue: int = 64             # admission bound: reject beyond this
    deadline_s: float = 2.0         # queued longer than this -> dropped
    batch_wait_s: float = 0.05      # linger before running a partial batch
    cost_base: float = 0.5          # per-batch setup, in host-speed units
    cost_per_item: float = 0.1      # marginal per request, host-speed units
    request_bytes: int = 2048       # query body on the wire
    response_bytes: int = 1024      # answer body on the wire

    def __post_init__(self):
        if self.max_batch < 1 or self.max_queue < 1:
            raise ValueError("max_batch and max_queue must be >= 1")
        if self.deadline_s <= 0 or self.batch_wait_s < 0:
            raise ValueError("deadline_s must be > 0, batch_wait_s >= 0")


@dataclass(frozen=True, eq=False)    # eq=False: may hold a TraceProfile
class ServeConfig:
    """One serving deployment riding on a training session.

    * ``n_replicas`` replicas are co-located with population nodes
      ``i % n`` (same city, link class and compute speed; ids ``n + i``).
    * every ``publish_every``-th completed round (plus round 1) is fanned
      out to all replicas as a :class:`~repro_torch.core.messages.SnapshotMsg`.
    * ``request_profile`` gates query arrivals: a client only issues
      requests while its timeline is online (None = the session's own
      trace profile; both None = ungated Poisson arrivals). Arrival draws
      come from ``default_rng(session_seed + seed_offset)`` in client-id
      order at install time (DL001/DL003).
    * ``spool_dir`` routes every real-params snapshot through
      ``checkpoint.save`` on publish and ``checkpoint.restore`` on
      install (the saxml servable-load path); ``restore_shardings`` is
      threaded into restore to place loaded leaves: None keeps each on
      the device of the training-side leaf, a device, a pytree of
      devices or a ``FlatShardings`` (its mesh's first device) moves them
      (``repro_torch.checkpoint.restore``).
    """

    n_replicas: int = 2
    publish_every: int = 1
    methods: Tuple[MethodConfig, ...] = (MethodConfig(),)
    request_profile: object = None          # TraceProfile or None
    rate_per_client: float = 0.5            # mean requests/s while online
    n_clients: Optional[int] = None         # default: population size
    routing: str = "round_robin"            # or "nearest" (min-latency)
    seed_offset: int = 424_242              # arrival-stream RNG offset
    max_requests: int = 200_000             # hard cap on generated queries
    spool_dir: Optional[str] = None
    restore_shardings: object = None        # threaded into checkpoint.restore

    def __post_init__(self):
        if self.n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if self.publish_every < 1:
            raise ValueError("publish_every must be >= 1")
        if not self.methods:
            raise ValueError("at least one MethodConfig required")
        if self.rate_per_client < 0:
            raise ValueError("rate_per_client must be >= 0")
        if self.routing not in ("round_robin", "nearest"):
            raise ValueError(f"unknown routing {self.routing!r}; "
                             "one of round_robin, nearest")


def _steady(n: int, seed: int, duration: float) -> ServeConfig:
    """Moderate always-available query load gated by the session's own
    trace profile (diurnal sessions see diurnal query load)."""
    return ServeConfig(n_replicas=2, rate_per_client=0.3)


def _flash_crowd(n: int, seed: int, duration: float) -> ServeConfig:
    """A flash-crowd *request* wave: most clients pile on partway through
    the run (the availability generator's arrival ramp re-read as query
    intensity), at a higher per-client rate."""
    return ServeConfig(
        n_replicas=2, rate_per_client=1.0,
        request_profile=flash_crowd_profile(n, seed=seed + 17))


# Request-load regimes for the ``serve=`` axis of
# ``repro_torch.eval.scenario_matrix``: (n, seed, duration) -> ServeConfig,
# mirroring FAULT_REGIMES so scenario cells stay seed-reproducible.
SERVE_REGIMES = {
    "steady": _steady,
    "flash_crowd": _flash_crowd,
}
