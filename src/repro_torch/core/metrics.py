"""Scheduler evaluation metrics (paper §4.3).

Copy of ``repro.core.metrics`` (framework-free).

- total time: first submission -> last completion
- cluster utilization: time-averaged used/total slots over that window; with
  a dynamic (cloud) cluster the denominator is the time-varying *provisioned*
  capacity, recorded via :meth:`UtilizationLog.record_capacity`
- weighted mean response time: sum(priority * (start - submit)) / sum(priority)
- weighted mean completion time: same with (end - submit)
- cost fields (cloud runs only): node-hours x pool price, wasted-idle dollars
- placement fields (multi-node runs): time-averaged fragmentation (free
  capacity stranded on partially-used nodes) and spot-kill blast radius —
  ``kill_blast_radius`` is the mean displaced slots PER RESIDENT JOB per
  kill, i.e. how concentrated the damage is: ``pack`` placement focuses a
  kill on few jobs (large radius), ``spread`` dilutes it (small radius)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.job import JobState, completion_time, response_time


def _integrate(events: Sequence[Tuple[float, float]], t0: float, t1: float,
               initial: float) -> float:
    """Area under a piecewise-constant step series over [t0, t1].  The value
    before the first event (and at t <= t0) is the last event at or before
    t0, else ``initial``."""
    area = 0.0
    cur = initial
    prev = t0
    for t, u in events:
        if t <= t0:
            cur = u
            continue
        tc = min(t, t1)
        area += cur * max(0.0, tc - prev)
        prev = max(prev, tc)
        cur = u
        if t >= t1:
            break
    area += cur * max(0.0, t1 - prev)
    return area


def _coalesce(series: List[Tuple[float, float]], t: float, value) -> None:
    """Append ``(t, value)``, coalescing same-timestamp updates: several
    state changes at one instant leave only the last value (a zero-width
    step contributes no area and would bloat the series)."""
    if series and series[-1][0] == t:
        series[-1] = (t, value)
    else:
        series.append((t, value))


class _Accum:
    """Running integral of one piecewise-constant stream: each record adds
    ``last_value * (t - last_t)`` — the exact float additions ``_integrate``
    would perform over the same in-window series, so the two agree bit-for-
    bit whenever every record falls inside the queried window (property-
    tested in tests/test_metrics_incremental.py).  Same-timestamp updates add
    a zero-width (0.0-area) segment and overwrite the value: identical to
    ``_coalesce`` + re-integrate."""

    __slots__ = ("first_t", "last_t", "value", "area")

    def __init__(self):
        self.first_t: Optional[float] = None
        self.last_t = 0.0
        self.value = 0.0
        self.area = 0.0

    def record(self, t: float, value: float) -> None:
        if self.first_t is None:
            self.first_t = t
        else:
            self.area += self.value * (t - self.last_t)
        self.last_t = t
        self.value = value

    def integral(self, t0: float, t1: float, initial: float) -> float:
        """Integral over [t0, t1], assuming the stream was ``initial`` before
        the first record.  Exact when t0 <= first_t and t1 >= last_t (the
        simulator's metrics window always satisfies both: records start at
        the first dispatch >= min submit and end at the last completion)."""
        if self.first_t is None:
            return initial * (t1 - t0)
        return (initial * max(0.0, self.first_t - t0) + self.area
                + self.value * max(0.0, t1 - self.last_t))


class UtilizationLog:
    """Step-series log of used slots / capacity / fragmentation.

    Two speeds (the fleet-scale refactor):

    - ``keep_series=True`` (default): full step series retained;
      ``average()`` integrates it offline with :func:`_integrate` —
      bit-identical to the original implementation, and what tracers /
      timelines / ``profile()`` consume.
    - ``keep_series=False``: bounded memory for million-event replays.  The
      used/fragmentation series are NOT retained; ``average()`` reads the
      O(1) running accumulators instead.  The capacity series is always
      retained (node lifecycle events are rare — and a fixed-capacity run
      has none), so dynamic-capacity averaging stays exact.

    The accumulators are maintained in BOTH modes, which is what lets the
    property suite assert incremental == offline on arbitrary interleavings.
    """

    def __init__(self, total_slots: int, *, keep_series: bool = True):
        self.total_slots = total_slots
        self.keep_series = keep_series
        self.events: List[Tuple[float, int]] = []            # (t, used)
        # (t, provisioned slots); empty = capacity fixed at total_slots
        self.capacity_events: List[Tuple[float, int]] = []
        # (t, fragmentation in [0,1]); empty = single-node cluster (undefined)
        self.frag_events: List[Tuple[float, float]] = []
        self._used_acc = _Accum()
        self._cap_acc = _Accum()
        self._frag_acc = _Accum()

    def record(self, t: float, used: int):
        # _coalesce + _Accum.record, inlined: this lands on every scheduling
        # action the simulator takes
        if self.keep_series:
            ev = self.events
            if ev and ev[-1][0] == t:
                ev[-1] = (t, used)
            else:
                ev.append((t, used))
        acc = self._used_acc
        if acc.first_t is None:
            acc.first_t = t
        else:
            acc.area += acc.value * (t - acc.last_t)
        acc.last_t = t
        acc.value = used

    def record_fragmentation(self, t: float, frag: float):
        if self.keep_series:
            _coalesce(self.frag_events, t, frag)
        self._frag_acc.record(t, frag)

    def record_capacity(self, t: float, total: int):
        _coalesce(self.capacity_events, t, total)
        self._cap_acc.record(t, total)

    def average(self, t0: float, t1: float) -> float:
        if t1 <= t0:
            return 0.0
        if self.keep_series:
            if not self.events:
                return 0.0
            used = _integrate(self.events, t0, t1, 0)
        else:
            if self._used_acc.first_t is None:
                return 0.0
            used = self._used_acc.integral(t0, t1, 0.0)
        if self.capacity_events:
            cap = _integrate(self.capacity_events, t0, t1,
                             float(self.total_slots))
        else:
            cap = self.total_slots * (t1 - t0)
        return used / cap if cap > 0 else 0.0

    def average_fragmentation(self, t0: float, t1: float) -> float:
        if t1 <= t0:
            return 0.0
        if self.keep_series:
            if not self.frag_events:
                return 0.0
            return _integrate(self.frag_events, t0, t1, 0.0) / (t1 - t0)
        if self._frag_acc.first_t is None:
            return 0.0
        return self._frag_acc.integral(t0, t1, 0.0) / (t1 - t0)

    def profile(self) -> List[Tuple[float, int]]:
        return list(self.events)


@dataclass(frozen=True)
class ScheduleMetrics:
    total_time: float
    utilization: float
    weighted_mean_response: float
    weighted_mean_completion: float
    rescale_count: int
    dropped_jobs: int = 0
    # cloud runs (repro_torch.cloud) — zero on fixed-capacity simulations
    total_cost: float = 0.0        # $ billed: node capacity + transfer
    idle_cost: float = 0.0         # $ of provisioned-but-unused slot time
    node_hours: float = 0.0        # billed node-hours
    spot_preemptions: int = 0      # nodes reclaimed by the spot market
    transfer_cost: float = 0.0     # $ of inter-region checkpoint transfer
    zone_reclaims: int = 0         # correlated zone events that killed nodes
    # placement (multi-node runs) — zero on single-node simulations
    avg_fragmentation: float = 0.0   # time-averaged stranded-free fraction
    kill_blast_jobs: float = 0.0     # mean jobs displaced per spot kill
    kill_blast_radius: float = 0.0   # mean displaced slots per victim job
    kill_preemptions: float = 0.0    # mean checkpoint-preempted jobs per kill
    # correlated (zone_reclaim) EVENT-level blasts: a job losing slots on
    # several nodes dying in one burst is ONE casualty of that burst
    zone_blast_jobs: float = 0.0     # mean jobs displaced per zone reclaim
    zone_blast_radius: float = 0.0   # mean displaced slots per victim job
    zone_preemptions: float = 0.0    # mean checkpoint-preempted per reclaim
    # spot bidding (cloud runs) — preemption-overhead dollars are an
    # attribution of capacity dollars already in total_cost, never additive
    preempt_overhead_cost: float = 0.0  # $ of ckpt write/restore slot-time
    bid_adjustments: int = 0         # bidder open<->closed zone flips
    # observed spot share by zone: spot slot-hours billed in the zone over
    # all billed slot-hours (empty on fixed-capacity or spotless runs)
    spot_share_by_zone: Dict[str, float] = field(default_factory=dict)
    # streaming latency percentiles (repro_torch.obs.stats.LatencyRecorder): flat
    # keys like ``resp_p99`` (all jobs) / ``resp_p99_prio5`` (one priority
    # class) for resp/compl/wait x p50/p95/p99; empty when no job completed
    percentiles: Dict[str, float] = field(default_factory=dict)
    # monotonic run counters (events processed, rescales, migrations, ...)
    counters: Dict[str, int] = field(default_factory=dict)
    # makespan decomposition (repro_torch.obs.critical_path): priority-weighted
    # mean seconds per phase over completed jobs — the phases PARTITION each
    # makespan, so the values sum to weighted_mean_completion
    phase_seconds: Dict[str, float] = field(default_factory=dict)
    # plain mean seconds per phase within one priority class, flattened as
    # ``prio<k>.<phase>``
    phase_by_priority: Dict[str, float] = field(default_factory=dict)
    # jobs whose single largest phase is <phase> (fleet histogram)
    dominant_phase: Dict[str, int] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        """Machine-readable form (plain scalars + dicts, JSON-safe) — the
        benchmark tables emit rows from this instead of ad-hoc formatting."""
        return dataclasses.asdict(self)

    def row(self) -> str:
        s = (f"total={self.total_time:9.1f}s util={self.utilization:6.2%} "
             f"resp={self.weighted_mean_response:8.2f}s "
             f"compl={self.weighted_mean_completion:8.2f}s "
             f"rescales={self.rescale_count}")
        if self.total_cost > 0.0:
            s += (f" cost=${self.total_cost:7.3f} idle=${self.idle_cost:6.3f}"
                  f" node_h={self.node_hours:5.2f}"
                  f" spot_kills={self.spot_preemptions}")
            if self.transfer_cost > 0.0 or self.zone_reclaims > 0:
                s += (f" xfer=${self.transfer_cost:6.4f}"
                      f" zone_reclaims={self.zone_reclaims}")
            if self.preempt_overhead_cost > 0.0 or self.bid_adjustments:
                s += (f" ovh=${self.preempt_overhead_cost:6.4f}"
                      f" bids={self.bid_adjustments}")
        if self.avg_fragmentation > 0.0 or self.kill_blast_jobs > 0.0:
            s += (f" frag={self.avg_fragmentation:5.2f}"
                  f" blast={self.kill_blast_radius:4.1f}")
        return s


def compute_metrics(jobs: Sequence[JobState], util: UtilizationLog, *,
                    latency=None, counters: Optional[Dict[str, int]] = None,
                    phases=None) -> ScheduleMetrics:
    """Cost fields stay at their zero defaults here; CloudSimulator's
    ``_final_metrics`` fills them from its CostReport via
    dataclasses.replace.  ``latency`` is a
    :class:`repro_torch.obs.stats.LatencyRecorder` (or anything with
    ``percentile_fields()``); ``counters`` a plain dict; ``phases`` a
    :class:`repro_torch.obs.critical_path.PhaseLedger` whose per-job makespan
    decompositions are rolled up into the ``phase_*`` fields."""
    done = [j for j in jobs if j.end_time is not None]
    submits = [j.spec.submit_time for j in jobs]
    t0 = min(submits) if submits else 0.0
    t1 = max((j.end_time for j in done), default=t0)
    wsum = sum(j.spec.priority for j in done) or 1.0
    resp = sum(j.spec.priority * (response_time(j) or 0.0) for j in done) / wsum
    comp = sum(j.spec.priority * (completion_time(j) or 0.0) for j in done) / wsum
    phase_kw = {}
    if phases is not None:
        from repro_torch.obs.critical_path import rollup
        fleet = rollup(phases.per_job(),
                       {j.spec.job_id: j.spec.priority for j in jobs})
        if fleet.jobs:
            phase_kw = dict(phase_seconds=fleet.phase_seconds,
                            phase_by_priority=fleet.phase_by_priority,
                            dominant_phase=fleet.dominant_phase)
    return ScheduleMetrics(
        total_time=t1 - t0,
        utilization=util.average(t0, t1),
        weighted_mean_response=resp,
        weighted_mean_completion=comp,
        rescale_count=sum(j.rescale_count for j in jobs),
        dropped_jobs=len(jobs) - len(done),
        avg_fragmentation=util.average_fragmentation(t0, t1),
        percentiles=(latency.percentile_fields()
                     if latency is not None else {}),
        counters=dict(counters) if counters else {},
        **phase_kw,
    )
