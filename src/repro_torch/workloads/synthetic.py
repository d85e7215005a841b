"""Seeded synthetic workload generators — same :class:`Trace` type as the
CSV loaders, so benchmarks swap arrival shapes without touching replay code.

Copy of ``repro.workloads.synthetic`` (framework-free), line for line, so both
packages give bit-equal results on the same inputs.

Arrival processes (the axis Zojer et al. show flips scheduler rankings):

- ``uniform``     fixed submission gap — the paper's §4.3.1 stream shape
- ``poisson``     memoryless arrivals at a constant rate
- ``bursty``      2-state Markov-modulated Poisson process (MMPP): long calm
                  stretches punctuated by dense bursts (interarrival CV >> 1)
- ``diurnal``     non-homogeneous Poisson with a sinusoidal day/night rate,
                  sampled by Lewis-Shedler thinning
- ``heavy_tail``  Poisson arrivals, Pareto job sizes AND durations (the
                  elephant-job tail real clusters carry)

Size/duration draws are lognormal unless a generator says otherwise; every
generator is a pure function of its seed (property-tested).  Raw priorities
are drawn from the Google-style 0..11 range so the same
``bucket_priorities`` pass applies to synthetic and loaded traces alike.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.workloads.trace import Trace, TraceJob


# ---------------------------------------------------------------------------
# arrival processes (return n sorted arrival times, seconds, starting near 0)
# ---------------------------------------------------------------------------

def _uniform_arrivals(rng, n: int, gap: float) -> np.ndarray:
    return np.arange(n, dtype=float) * gap


def _poisson_arrivals(rng, n: int, rate: float) -> np.ndarray:
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def _mmpp_arrivals(rng, n: int, rate_calm: float, rate_burst: float,
                   dwell_calm: float, dwell_burst: float) -> np.ndarray:
    """2-state MMPP: alternate Exp-dwell calm/burst phases; within a phase,
    Poisson arrivals at that phase's rate."""
    out, t, burst = [], 0.0, False
    while len(out) < n:
        dwell = float(rng.exponential(dwell_burst if burst else dwell_calm))
        rate = rate_burst if burst else rate_calm
        phase_end = t + dwell
        while len(out) < n:
            t += float(rng.exponential(1.0 / rate))
            if t > phase_end:
                t = phase_end
                break
            out.append(t)
        burst = not burst
    return np.array(out)


def _diurnal_arrivals(rng, n: int, base_rate: float, amplitude: float,
                      period: float) -> np.ndarray:
    """Thinning: candidate Poisson at the peak rate, accept with
    lambda(t)/lambda_max where lambda(t) = base*(1 + A*sin(2*pi*t/T))."""
    assert 0.0 <= amplitude < 1.0
    peak = base_rate * (1.0 + amplitude)
    out, t = [], 0.0
    while len(out) < n:
        t += float(rng.exponential(1.0 / peak))
        lam = base_rate * (1.0 + amplitude * math.sin(2 * math.pi * t / period))
        if rng.random() < lam / peak:
            out.append(t)
    return np.array(out)


# ---------------------------------------------------------------------------
# size / duration draws
# ---------------------------------------------------------------------------

def _lognormal(rng, n: int, median: float, sigma: float) -> np.ndarray:
    return rng.lognormal(mean=math.log(median), sigma=sigma, size=n)


def _pareto(rng, n: int, alpha: float, scale: float) -> np.ndarray:
    """Pareto(alpha) with minimum ``scale`` (numpy's is the Lomax shift)."""
    return scale * (1.0 + rng.pareto(alpha, size=n))


def _assemble(name: str, arrivals: np.ndarray, slots: np.ndarray,
              durations: np.ndarray, priorities: np.ndarray) -> Trace:
    jobs = tuple(
        TraceJob(job_id=f"{name}-{i:04d}", submit_time=float(t),
                 duration=float(d), slots=int(max(1, round(s))),
                 priority=int(p))
        for i, (t, s, d, p) in enumerate(
            zip(arrivals, slots, durations, priorities)))
    return Trace(name=name, jobs=jobs, source="synthetic").sorted()


def _common(rng, n: int, slot_median: float, slot_sigma: float,
            duration_median: float, duration_sigma: float):
    slots = _lognormal(rng, n, slot_median, slot_sigma)
    durations = _lognormal(rng, n, duration_median, duration_sigma)
    priorities = rng.integers(0, 12, size=n)
    return slots, durations, priorities


# ---------------------------------------------------------------------------
# public generators — pure functions of their seed
# ---------------------------------------------------------------------------

def uniform_trace(n_jobs: int = 24, seed: int = 0, *, gap: float = 90.0,
                  slot_median: float = 6.0, slot_sigma: float = 0.5,
                  duration_median: float = 600.0,
                  duration_sigma: float = 0.4) -> Trace:
    rng = np.random.default_rng(seed)
    slots, durations, prio = _common(rng, n_jobs, slot_median, slot_sigma,
                                     duration_median, duration_sigma)
    return _assemble("uniform", _uniform_arrivals(rng, n_jobs, gap),
                     slots, durations, prio)


def poisson_trace(n_jobs: int = 24, seed: int = 0, *, rate: float = 1 / 90.0,
                  slot_median: float = 6.0, slot_sigma: float = 0.5,
                  duration_median: float = 600.0,
                  duration_sigma: float = 0.4) -> Trace:
    rng = np.random.default_rng(seed)
    slots, durations, prio = _common(rng, n_jobs, slot_median, slot_sigma,
                                     duration_median, duration_sigma)
    return _assemble("poisson", _poisson_arrivals(rng, n_jobs, rate),
                     slots, durations, prio)


def bursty_trace(n_jobs: int = 24, seed: int = 0, *,
                 rate_calm: float = 1 / 600.0, rate_burst: float = 1 / 15.0,
                 dwell_calm: float = 900.0, dwell_burst: float = 120.0,
                 slot_median: float = 6.0, slot_sigma: float = 0.5,
                 duration_median: float = 600.0,
                 duration_sigma: float = 0.4) -> Trace:
    rng = np.random.default_rng(seed)
    slots, durations, prio = _common(rng, n_jobs, slot_median, slot_sigma,
                                     duration_median, duration_sigma)
    arrivals = _mmpp_arrivals(rng, n_jobs, rate_calm, rate_burst,
                              dwell_calm, dwell_burst)
    return _assemble("bursty", arrivals, slots, durations, prio)


def diurnal_trace(n_jobs: int = 24, seed: int = 0, *,
                  base_rate: float = 1 / 90.0, amplitude: float = 0.9,
                  period: float = 3600.0, slot_median: float = 6.0,
                  slot_sigma: float = 0.5, duration_median: float = 600.0,
                  duration_sigma: float = 0.4) -> Trace:
    rng = np.random.default_rng(seed)
    slots, durations, prio = _common(rng, n_jobs, slot_median, slot_sigma,
                                     duration_median, duration_sigma)
    arrivals = _diurnal_arrivals(rng, n_jobs, base_rate, amplitude, period)
    return _assemble("diurnal", arrivals, slots, durations, prio)


def heavy_tail_trace(n_jobs: int = 24, seed: int = 0, *,
                     rate: float = 1 / 90.0, size_alpha: float = 1.5,
                     size_scale: float = 2.0, duration_alpha: float = 1.3,
                     duration_scale: float = 120.0) -> Trace:
    """Pareto sizes and durations: a few elephants dominate slot-seconds."""
    rng = np.random.default_rng(seed)
    slots = _pareto(rng, n_jobs, size_alpha, size_scale)
    durations = _pareto(rng, n_jobs, duration_alpha, duration_scale)
    priorities = rng.integers(0, 12, size=n_jobs)
    return _assemble("heavy_tail", _poisson_arrivals(rng, n_jobs, rate),
                     slots, durations, priorities)


def _fleet_arrivals(rng, n: int, horizon: float, amplitude: float,
                    period: float) -> np.ndarray:
    """Vectorized diurnal sampler: ``n`` arrival times in ``[0, horizon)``
    with density proportional to ``1 + A*sin(2*pi*t/T)`` (rejection sampling
    in numpy batches).  The sequential thinning loop in
    :func:`_diurnal_arrivals` is exact too, but at fleet scale (~1M jobs) a
    per-candidate Python iteration dominates the whole replay."""
    assert 0.0 <= amplitude < 1.0
    out = np.empty(0)
    while out.size < n:
        m = int((n - out.size) * 1.8) + 16
        t = rng.random(m) * horizon
        keep = rng.random(m) * (1.0 + amplitude) \
            < 1.0 + amplitude * np.sin(2 * math.pi * t / period)
        out = np.concatenate([out, t[keep]])
    return np.sort(out[:n])


def google_fleet_trace(n_jobs: int = 1_000_000, seed: int = 0, *,
                       days: float = 30.0, nodes: int = 10_000,
                       slots_per_node: int = 8, target_load: float = 0.7,
                       amplitude: float = 0.6, slot_median: float = 24.0,
                       slot_sigma: float = 1.0, duration_sigma: float = 1.1,
                       max_job_fraction: float = 0.02) -> Trace:
    """Month-long Google-shape fleet trace (the ROADMAP fleet-scale bench):
    day/night diurnal arrivals over ``days``, lognormal slot demands capped
    at ``max_job_fraction`` of the cluster, and lognormal durations scaled so
    the offered load — total slot-seconds over capacity x horizon — lands
    exactly on ``target_load`` (< 1, or the backlog never drains).  Raw
    priorities use the Google 0..11 range; replay buckets them like every
    other trace.  Fully vectorized: generating ~1M jobs takes seconds."""
    assert 0.0 < target_load < 1.0
    rng = np.random.default_rng(seed)
    horizon = days * 86400.0
    capacity = nodes * slots_per_node
    arrivals = _fleet_arrivals(rng, n_jobs, horizon, amplitude, 86400.0)
    slots = np.clip(np.round(_lognormal(rng, n_jobs, slot_median,
                                        slot_sigma)),
                    1, max(1, int(capacity * max_job_fraction)))
    # unit-median durations, then one global scale pins the realized load
    d0 = _lognormal(rng, n_jobs, 1.0, duration_sigma)
    need = target_load * capacity * horizon          # slot-seconds to offer
    durations = np.maximum(30.0, d0 * (need / float(np.sum(slots * d0))))
    priorities = rng.integers(0, 12, size=n_jobs)
    return _assemble("fleet", arrivals, slots, durations, priorities)


GENERATORS: Dict[str, Callable[..., Trace]] = {
    "uniform": uniform_trace,
    "poisson": poisson_trace,
    "bursty": bursty_trace,
    "diurnal": diurnal_trace,
    "heavy_tail": heavy_tail_trace,
    "fleet": google_fleet_trace,
}


def generate(kind: str, n_jobs: int = 24, seed: int = 0, **kw) -> Trace:
    """Dispatch by shape name (the table4 grid iterates this registry)."""
    return GENERATORS[kind](n_jobs=n_jobs, seed=seed, **kw)
