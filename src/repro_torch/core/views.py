"""Views — the (C_i, E_i, N_i) triple piggybacked on model transfers (§3.6).

Views are the only membership traffic in MoDeST; their wire size is
accounted per entry so the Table-4 overhead experiment can be reproduced.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.activity import ActivityTracker
from repro_torch.core.registry import Registry

# Wire-size model: 8B node id hash + 8B counter + 1B event + 8B activity
# round + small framing. The paper does not publish its exact encoding; the
# Table-4 overhead percentages reproduce with any constant of this order.
BYTES_PER_ENTRY = 28
VIEW_HEADER_BYTES = 16


@dataclass
class View:
    registry: Registry
    activity: ActivityTracker

    @staticmethod
    def of(registry: Registry, activity: ActivityTracker) -> "View":
        """VIEW() — snapshot for piggybacking (copies: wire immutability)."""
        return View(registry.snapshot(), activity.snapshot())

    def merge_into(self, registry: Registry, activity: ActivityTracker) -> None:
        """MERGEVIEW — merge a received view into local state."""
        registry.merge(self.registry)
        activity.merge(self.activity)

    def size_bytes(self) -> int:
        n = max(len(self.registry), len(self.activity.latest))
        return VIEW_HEADER_BYTES + n * BYTES_PER_ENTRY
