"""Workload characterization — the numbers that name a workload's *shape*.

Copy of ``repro.workloads.stats`` (framework-free), line for line, so both
packages give bit-equal results on the same inputs.

Every benchmark row that reports a scheduler verdict should also say what
kind of pressure the scheduler was under; otherwise "elastic wins" is a claim
about one arrival pattern.  :func:`characterize` computes:

- interarrival mean and CV (CV=0 fixed gap, CV=1 Poisson, CV>1 bursty);
- burstiness index B = (sigma - mu)/(sigma + mu) of interarrivals (Goh &
  Barabasi), in [-1, 1): -1 periodic, 0 Poisson, ->1 extreme bursts;
- peak-to-mean arrival rate over fixed windows (how hard the worst burst
  hits an autoscaler's provisioning loop);
- size-tail index: Hill estimator on per-job slot-seconds (the "mass" a job
  drops on the cluster); alpha <= 2 means elephants dominate — infinite for
  degenerate/light tails;
- demand quantiles and total offered slot-seconds.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.workloads.trace import Trace


@dataclass(frozen=True)
class WorkloadStats:
    n_jobs: int
    horizon: float                   # first -> last arrival (s)
    interarrival_mean: float
    interarrival_cv: float
    burstiness: float                # (sigma-mu)/(sigma+mu), [-1, 1)
    peak_rate_ratio: float           # max windowed rate / mean rate
    duration_mean: float
    duration_p95: float
    slots_mean: float
    slots_p95: float
    slots_max: int
    tail_index: float                # Hill alpha on slot-seconds; inf = light
    slot_seconds: float              # total offered work

    def kv(self) -> str:
        """Compact characterization for a benchmark row's derived field."""
        tail = "inf" if math.isinf(self.tail_index) else \
            f"{self.tail_index:.2f}"
        return (f"jobs={self.n_jobs};cv={self.interarrival_cv:.2f};"
                f"burst={self.burstiness:.2f};peak={self.peak_rate_ratio:.1f};"
                f"tail={tail};p95_slots={self.slots_p95:.0f}")

    def describe(self) -> str:
        return (f"{self.n_jobs} jobs over {self.horizon:.0f}s | "
                f"interarrival {self.interarrival_mean:.1f}s "
                f"CV={self.interarrival_cv:.2f} B={self.burstiness:.2f} "
                f"peak/mean={self.peak_rate_ratio:.1f} | "
                f"dur mean={self.duration_mean:.0f}s "
                f"p95={self.duration_p95:.0f}s | "
                f"slots mean={self.slots_mean:.1f} max={self.slots_max} "
                f"tail_alpha={self.tail_index:.2f} | "
                f"offered={self.slot_seconds / 3600.0:.1f} slot-h")


def hill_tail_index(values, k: Optional[int] = None) -> float:
    """Hill estimator of the Pareto tail exponent alpha over the top-k order
    statistics (k defaults to the top 20%, floor 3).  Returns +inf when the
    tail is degenerate (top values equal) — i.e. no power-law tail."""
    x = np.sort(np.asarray(values, dtype=float))
    n = len(x)
    if n < 4 or x[0] <= 0.0:
        return math.inf
    k = k if k is not None else max(3, n // 5)
    k = min(k, n - 1)
    top, ref = x[n - k:], x[n - k - 1]
    logs = np.log(top / ref)
    m = float(np.mean(logs))
    return 1.0 / m if m > 0.0 else math.inf


def characterize(trace: Trace, *, window: Optional[float] = None,
                 tail_k: Optional[int] = None) -> WorkloadStats:
    """Compute :class:`WorkloadStats` for a trace.  ``window`` sets the
    arrival-rate bucketing (defaults to horizon/12, floor 1 s)."""
    arr = np.sort(np.asarray(trace.arrivals(), dtype=float))
    durs = np.array([j.duration for j in trace.jobs], dtype=float)
    slots = np.array([j.slots for j in trace.jobs], dtype=float)
    n = len(arr)
    if n < 2:
        return WorkloadStats(
            n_jobs=n, horizon=0.0, interarrival_mean=0.0,
            interarrival_cv=0.0, burstiness=-1.0, peak_rate_ratio=1.0,
            duration_mean=float(durs.mean()) if n else 0.0,
            duration_p95=float(durs.max()) if n else 0.0,
            slots_mean=float(slots.mean()) if n else 0.0,
            slots_p95=float(slots.max()) if n else 0.0,
            slots_max=int(slots.max()) if n else 0,
            tail_index=math.inf,
            slot_seconds=trace.slot_seconds)
    gaps = np.diff(arr)
    mu = float(gaps.mean())
    sigma = float(gaps.std())
    cv = sigma / mu if mu > 0.0 else 0.0
    burst = (sigma - mu) / (sigma + mu) if sigma + mu > 0.0 else -1.0
    horizon = float(arr[-1] - arr[0])
    window = window if window is not None else max(1.0, horizon / 12.0)
    if horizon > 0.0:
        counts, _ = np.histogram(
            arr, bins=max(1, int(math.ceil(horizon / window))),
            range=(arr[0], arr[-1]))
        mean_rate = counts.mean()
        peak = float(counts.max() / mean_rate) if mean_rate > 0.0 else 1.0
    else:
        peak = float(n)                     # everything in one instant
    return WorkloadStats(
        n_jobs=n,
        horizon=horizon,
        interarrival_mean=mu,
        interarrival_cv=cv,
        burstiness=burst,
        peak_rate_ratio=peak,
        duration_mean=float(durs.mean()),
        duration_p95=float(np.percentile(durs, 95)),
        slots_mean=float(slots.mean()),
        slots_p95=float(np.percentile(slots, 95)),
        slots_max=int(slots.max()),
        tail_index=hill_tail_index(slots * durs, k=tail_k),
        slot_seconds=trace.slot_seconds)
