"""Trace-driven heterogeneity: realistic compute / network / availability
profiles for the simulator (the paper's §4.2 methodology as a subsystem).

Typical use::

    from repro_torch.traces import diurnal_profile
    from repro_torch.sim.runner import ModestSession

    session = ModestSession(profile=diurnal_profile(n=64, seed=0))
    result = session.run(600.0)      # churn driven by the trace, no
                                     # manual schedule_crash calls

See ``docs/TRACES.md`` for the schema and generator catalogue.
"""

from repro_torch.traces.availability import AvailabilityTimeline  # noqa: F401
from repro_torch.traces.generators import (  # noqa: F401
    always_on,
    asymmetric_bandwidth,
    diurnal_availability,
    diurnal_profile,
    flash_crowd_profile,
    fragmented_availability,
    homogeneous_profile,
    lognormal_speeds,
    starved_cohort_profile,
    zipf_speeds,
)
from repro_torch.traces.profile import TraceProfile  # noqa: F401
