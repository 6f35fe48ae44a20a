"""Homogeneous vs trace-driven heterogeneity, side by side (§4.2), on the
PyTorch package.

Runs the same MoDeST protocol twice: once on the naive control profile
(identical speeds, symmetric bandwidth, everyone always online) and once
on the realistic diurnal trace profile (lognormal device speeds,
asymmetric last-mile links, sine-windowed availability with per-node
phase). Churn in the second run comes entirely from the availability
traces — no manual schedule_crash calls. The twin of
``examples/trace_replay.py``: the same sessions (byte-only tasks) and the
same printed lines; the sessions are built on the card unless ``--device``
names another device.

    PYTHONPATH=src python examples/torch_trace_replay.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.sim.runner import ModestSession
from repro_torch.traces import diurnal_profile, homogeneous_profile

N, SEED, DURATION = 64, 0, 600.0


def run_profile(profile, device=None):
    session = ModestSession(profile=profile, device=device)
    res = session.run(DURATION)
    iv = res.round_intervals() or [float("nan")]
    sd = [d for _, d in res.sample_durations] or [float("nan")]
    return {
        "rounds": res.rounds_completed,
        "mean_round_s": float(np.mean(iv)),
        "p50_round_s": float(np.median(iv)),
        "p95_round_s": float(np.percentile(iv, 95)),
        "sample_ms": 1000 * float(np.mean(sd)),
        "total_gb": res.usage["total_bytes"] / 1e9,
        "churn_events": res.churn_events,
    }


def profiles():
    return {
        "homogeneous": homogeneous_profile(N, seed=SEED),
        "trace-driven": diurnal_profile(n=N, seed=SEED),
    }


def run(device=None):
    """Both profiles' rows: ``{name: row}``."""
    return {name: run_profile(p, device) for name, p in profiles().items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    print(f"MoDeST, n={N}, {DURATION:.0f}s simulated, seed={SEED}\n")
    for name, p in profiles().items():
        d = p.describe()
        print(f"  {name:13s} speed p50/p95 = {d['speed_p50_s']*1e3:.0f}/"
              f"{d['speed_p95_s']*1e3:.0f} ms/batch, "
              f"up/down = {d['uplink_mean_mbps']:.0f}/"
              f"{d['downlink_mean_mbps']:.0f} Mbps, "
              f"availability = {d['mean_availability']:.0%}")
    rows = run(args.device)

    print()
    keys = [("rounds completed", "rounds", "{:.0f}"),
            ("mean round time (s)", "mean_round_s", "{:.2f}"),
            ("p50 round time (s)", "p50_round_s", "{:.2f}"),
            ("p95 round time (s)", "p95_round_s", "{:.2f}"),
            ("mean SAMPLE() (ms)", "sample_ms", "{:.1f}"),
            ("network total (GB)", "total_gb", "{:.2f}"),
            ("churn events", "churn_events", "{:.0f}")]
    names = list(rows)
    print(f"  {'':24s} {names[0]:>14s} {names[1]:>14s}")
    for label, key, fmt in keys:
        a, b = (fmt.format(rows[n][key]) for n in names)
        print(f"  {label:24s} {a:>14s} {b:>14s}")

    slow = rows["trace-driven"]["mean_round_s"] / rows["homogeneous"]["mean_round_s"]
    print(f"\n  realistic heterogeneity stretches the mean round "
          f"{slow:.1f}x — the regime the paper's time-to-accuracy "
          f"claims are measured in.")
    return rows


if __name__ == "__main__":
    main()
