"""Discrete-event WAN simulator.

Replaces the paper's asyncio + IPv8/UDP deployment (the paper itself
simulates time for its DL comparisons, §4.2). Provides:

* :class:`repro_torch.sim.clock.Simulator` — event queue with virtual time
* :class:`repro_torch.sim.network.Network` — latency-matrix message delivery with
  per-node / per-message-type byte accounting (Table 4)
* :mod:`repro_torch.sim.churn` — join/leave/crash schedules (Figs. 5–6)
* :mod:`repro_torch.sim.fault` — declarative fault injection (loss, duplication,
  reordering, partitions, stragglers, aggregator kills; docs/FAULTS.md)
* :mod:`repro_torch.sim.runner` — session drivers for MoDeST / FedAvg / D-SGD
"""

from repro_torch.sim.churn import AvailabilityDriver  # noqa: F401
from repro_torch.sim.clock import Simulator  # noqa: F401
from repro_torch.sim.fault import (AggregatorKill, Drop, Duplicate,  # noqa: F401
                             FaultInjector, FaultSchedule, Jitter,
                             LatencySpike, Partition, Straggler)
from repro_torch.sim.network import Network, wan_latency_matrix  # noqa: F401
