"""Per-job makespan decomposition into named phases + fleet rollups.

Copy of ``repro.obs.critical_path`` (framework-free).

Where did a job's makespan go?  The paper's headline metrics (response time,
rescale overhead) are scalars; this module attributes every second between
``submit`` and ``complete`` to exactly one of the :data:`PHASES`:

==============  ============================================================
phase           seconds spent ...
==============  ============================================================
``queue_wait``  waiting for slots before the FIRST start (minus boot_wait)
``boot_wait``   part of that initial wait while cloud nodes were booting —
                capacity was coming, the job just had to outlast the boot
``ckpt``        writing the preemption checkpoint (clock advance before the
                victim's slots free up)
``outage``      kill/preempt -> resume gap: the job held nothing and made no
                progress (the paper's kill->resume outage)
``restore``     restoring the checkpoint after a resume
``rescale``     shrink/expand/migrate overhead windows (the fig5 stages)
``compute``     the remainder of every running segment — actual progress
==============  ============================================================

The phases PARTITION the makespan: for every completed job,
``sum(phases.values()) == end_time - submit_time`` exactly (this is enforced
to <0.1% by the trace auditor on table1 + fig5 traces, and by construction
here — ``compute`` is the measured remainder of the running segments, never
an independent estimate).

One engine, two feeds:

- **live**: every ``Simulator`` owns a
  :class:`PhaseLedger` and calls its ``on_*`` hooks from the same code paths
  that emit trace records, so every run — traced or not — lands attributed
  phase fields in :class:`~repro_torch.core.metrics.ScheduleMetrics`
  (``phase_seconds`` / ``phase_by_priority`` / ``dominant_phase``);
- **offline**: :func:`decompose` replays a flight-recorder JSONL stream
  (one run) through the same ledger, and :func:`analyze` adds the fleet
  rollups + the longest causal chain from :mod:`repro_torch.obs.spans`.

The overhead-window bookkeeping mirrors the simulator exactly: windows stack
(``start = max(t, overhead_until)``), a preempt clips open windows at the
segment boundary, and the backdated checkpoint window never overlaps a
stacked window, so no second is attributed twice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: the named phases, in causal order; compute is always last (the remainder)
PHASES = ("queue_wait", "boot_wait", "ckpt", "outage", "restore", "rescale",
          "compute")


def merge_intervals(ivs: List[Tuple[float, float]]
                    ) -> List[Tuple[float, float]]:
    """Union of possibly-overlapping intervals (sorted, merged)."""
    out: List[Tuple[float, float]] = []
    for t0, t1 in sorted(ivs):
        if t1 <= t0:
            continue
        if out and t0 <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t1))
        else:
            out.append((t0, t1))
    return out


def overlap(window: Tuple[float, float],
            ivs: List[Tuple[float, float]]) -> float:
    """Measure of ``window`` covered by the (merged) interval union."""
    w0, w1 = window
    return sum(max(0.0, min(w1, t1) - max(w0, t0)) for t0, t1 in ivs)


class _JobPhases:
    """Per-job raw material: wait windows, running segments, overhead
    windows.  Finalized into a phase dict once the lifecycle ends."""

    __slots__ = ("submit_t", "wait_from", "wait_kind", "seg_start",
                 "segments", "windows", "ovh_until", "end_t", "started")

    def __init__(self, submit_t: float):
        self.submit_t = submit_t
        self.wait_from: Optional[float] = submit_t
        self.wait_kind = "initial"
        self.seg_start: Optional[float] = None
        self.segments: List[Tuple[float, float]] = []
        # (phase, t0, t1) overhead windows, non-overlapping by construction
        self.windows: List[Tuple[str, float, float]] = []
        self.ovh_until = 0.0
        self.end_t: Optional[float] = None
        self.started = False

    # -- lifecycle -----------------------------------------------------------
    def start(self, t: float, restore_s: float,
              outages: List[Tuple[float, float]]) -> None:
        if self.wait_from is not None and self.wait_kind == "outage":
            outages.append((self.wait_from, t))
        self.wait_from = None
        self.seg_start = t
        self.started = True
        # mirror of Simulator create: overhead_until is ASSIGNED (not
        # stacked) on resume, 0-width for a first start
        self.ovh_until = t + restore_s
        if restore_s > 0.0:
            self.windows.append(("restore", t, t + restore_s))

    def overhead(self, phase: str, t: float, seconds: float) -> None:
        if self.seg_start is None or seconds <= 0.0:
            return
        t0 = max(t, self.ovh_until)     # mirror: max(now, overhead_until)
        self.windows.append((phase, t0, t0 + seconds))
        self.ovh_until = t0 + seconds

    def preempt(self, t: float, ckpt_s: float) -> None:
        """``t`` is the post-checkpoint emission time (the simulator advances
        the clock by ``ckpt_s`` before the record lands)."""
        if self.seg_start is None:
            return
        if ckpt_s > 0.0:
            # backdated window; its start is clipped past any stacked window
            # (they all end at ovh_until) so the partition never double-counts
            c0 = max(self.seg_start, t - ckpt_s, min(self.ovh_until, t))
            if t > c0:
                self.windows.append(("ckpt", c0, t))
        self._close_segment(t)
        self.wait_from, self.wait_kind = t, "outage"

    def fail(self, t: float) -> None:
        self._close_segment(t)
        self.wait_from, self.wait_kind = t, "outage"

    def complete(self, t: float) -> None:
        self._close_segment(t)
        self.end_t = t

    def _close_segment(self, t: float) -> None:
        if self.seg_start is not None:
            self.segments.append((self.seg_start, t))
            self.seg_start = None
        self.ovh_until = min(self.ovh_until, t)

    # -- finalize ------------------------------------------------------------
    def phases(self, outages: List[Tuple[float, float]],
               boot_windows: List[Tuple[float, float]]
               ) -> Optional[Dict[str, float]]:
        """The finalized partition, or None while the job is still live."""
        if self.end_t is None or not self.started:
            return None
        out = dict.fromkeys(PHASES, 0.0)
        first_start = self.segments[0][0] if self.segments else self.end_t
        if boot_windows:
            init = (self.submit_t, first_start)
            boot = overlap(init, merge_intervals(boot_windows))
        else:       # pure-sim run: no node boots (int 0, like sum(()))
            boot = 0
        out["boot_wait"] = boot
        out["queue_wait"] = max(0.0, (first_start - self.submit_t) - boot)
        out["outage"] = sum(t1 - t0 for t0, t1 in outages)
        running = sum(t1 - t0 for t0, t1 in self.segments)
        attributed = 0.0
        for phase, w0, w1 in self.windows:
            d = overlap((w0, w1), self.segments)
            out[phase] += d
            attributed += d
        out["compute"] = max(0.0, running - attributed)
        return out


class PhaseLedger:
    """Always-on per-job phase accumulator.  The hooks are cheap (a few dict
    ops per lifecycle action, nothing per event) — ``obs.profile`` measures
    their cost as part of the handler timings."""

    def __init__(self):
        self._jobs: Dict[str, _JobPhases] = {}
        self._outages: Dict[str, List[Tuple[float, float]]] = {}
        self._boot_windows: List[Tuple[float, float]] = []
        self._prio: Dict[str, int] = {}

    # -- hooks (called by the simulators / the offline feed) -----------------
    def on_submit(self, job_id: str, t: float,
                  priority: Optional[int] = None) -> None:
        self._jobs[job_id] = _JobPhases(t)
        self._outages[job_id] = []
        if priority is not None:
            self._prio[job_id] = priority

    def on_start(self, job_id: str, t: float, restore_s: float = 0.0) -> None:
        jp = self._jobs.get(job_id)
        if jp is not None:
            jp.start(t, restore_s, self._outages[job_id])

    def on_rescale(self, job_id: str, t: float, overhead_s: float) -> None:
        jp = self._jobs.get(job_id)
        if jp is not None:
            jp.overhead("rescale", t, overhead_s)

    # a migration pays the rescale-model overhead — same phase family
    on_migrate = on_rescale

    def on_preempt(self, job_id: str, t: float, ckpt_s: float) -> None:
        jp = self._jobs.get(job_id)
        if jp is not None:
            jp.preempt(t, ckpt_s)

    def on_fail(self, job_id: str, t: float) -> None:
        jp = self._jobs.get(job_id)
        if jp is not None:
            jp.fail(t)

    def on_complete(self, job_id: str, t: float) -> None:
        jp = self._jobs.get(job_id)
        if jp is not None:
            jp.complete(t)

    def note_boot_window(self, t0: float, t1: float) -> None:
        """A cloud node's request->up interval; overlaps with initial waits
        become ``boot_wait``.  Duplicates are fine (the union dedups)."""
        if t1 > t0:
            self._boot_windows.append((t0, t1))

    # -- results -------------------------------------------------------------
    def phases_of(self, job_id: str) -> Optional[Dict[str, float]]:
        jp = self._jobs.get(job_id)
        if jp is None:
            return None
        return jp.phases(self._outages[job_id], self._boot_windows)

    def per_job(self) -> Dict[str, Dict[str, float]]:
        """Finalized decompositions for every completed job."""
        out = {}
        for job_id in self._jobs:
            ph = self.phases_of(job_id)
            if ph is not None:
                out[job_id] = ph
        return out

    def priority_of(self, job_id: str) -> int:
        return self._prio.get(job_id, 1)


class NullPhaseLedger(PhaseLedger):
    """No-op ledger for bounded-memory fleet runs (``Simulator(...,
    track_phases=False)``): a million-job replay must not retain per-job
    phase state it will never roll up.  ``per_job()`` stays empty, so
    ``compute_metrics`` simply leaves the ``phase_*`` fields at their
    defaults."""

    def on_submit(self, job_id, t, priority=None):
        pass

    def on_start(self, job_id, t, restore_s=0.0):
        pass

    def on_rescale(self, job_id, t, overhead_s):
        pass

    on_migrate = on_rescale

    def on_preempt(self, job_id, t, ckpt_s):
        pass

    def on_fail(self, job_id, t):
        pass

    def on_complete(self, job_id, t):
        pass

    def note_boot_window(self, t0, t1):
        pass


# ---------------------------------------------------------------------------
# Offline: feed a flight-recorder stream through the same ledger
# ---------------------------------------------------------------------------

def feed_record(ledger: PhaseLedger, r: Dict[str, Any]) -> None:
    """Apply one trace record to a ledger (the offline/online shared feed)."""
    kind = r.get("kind")
    if kind is None or not kind.startswith(("job_", "node_up")):
        return
    t = r.get("t", 0.0)
    if kind == "job_submit":
        ledger.on_submit(r["job"], t, priority=r.get("priority"))
    elif kind == "job_start":
        ledger.on_start(r["job"], t,
                        restore_s=(r.get("overhead_s", 0.0)
                                   if r.get("resume") else 0.0))
    elif kind == "job_rescale":
        ledger.on_rescale(r["job"], t, r.get("overhead_s", 0.0))
    elif kind == "job_migrate":
        ledger.on_migrate(r["job"], t, r.get("overhead_s", 0.0))
    elif kind == "job_preempt":
        ledger.on_preempt(r["job"], t, r.get("ckpt_s", 0.0))
    elif kind == "job_fail":
        ledger.on_fail(r["job"], t)
    elif kind == "job_complete":
        ledger.on_complete(r["job"], t)
    elif kind == "node_up" and r.get("boot_s", 0.0) > 0.0:
        ledger.note_boot_window(t - r["boot_s"], t)


def decompose(records: Sequence[Dict[str, Any]]
              ) -> Dict[str, Dict[str, float]]:
    """Per-job phase decomposition of ONE run's records."""
    ledger = PhaseLedger()
    for r in records:
        feed_record(ledger, r)
    return ledger.per_job()


# ---------------------------------------------------------------------------
# Fleet rollups
# ---------------------------------------------------------------------------

@dataclass
class FleetPhases:
    """Fleet-level rollup of per-job decompositions."""
    jobs: int = 0
    #: priority-weighted mean seconds per phase; sums to the weighted mean
    #: completion time of the covered jobs
    phase_seconds: Dict[str, float] = field(default_factory=dict)
    #: plain mean seconds per phase within one priority class, flattened as
    #: ``prio<k>.<phase>``
    phase_by_priority: Dict[str, float] = field(default_factory=dict)
    #: jobs whose single largest phase is <phase>
    dominant_phase: Dict[str, int] = field(default_factory=dict)
    #: longest cause-edge chain in the run's span graph (offline only)
    longest_causal_chain: int = 0

    def shares(self) -> Dict[str, float]:
        total = sum(self.phase_seconds.values())
        if total <= 0.0:
            return {}
        return {p: s / total for p, s in self.phase_seconds.items()}


def rollup(per_job: Dict[str, Dict[str, float]],
           priorities: Dict[str, int]) -> FleetPhases:
    """Aggregate per-job phase dicts (priority-weighted, like WMCT)."""
    if not per_job:
        return FleetPhases()
    wsum = sum(priorities.get(j, 1) for j in per_job) or 1.0
    agg = {p: 0.0 for p in PHASES}
    by_prio: Dict[int, Dict[str, float]] = {}
    counts: Dict[int, int] = {}
    dominant: Dict[str, int] = {}
    for job_id, ph in per_job.items():
        w = priorities.get(job_id, 1)
        cls = by_prio.setdefault(w, dict.fromkeys(PHASES, 0.0))
        counts[w] = counts.get(w, 0) + 1
        top, top_v = None, -1.0     # first maximal phase, like max(PHASES)
        for p in PHASES:
            v = ph.get(p, 0.0)
            agg[p] += w * v
            cls[p] += v
            if v > top_v:
                top, top_v = p, v
        dominant[top] = dominant.get(top, 0) + 1
    flat = {}
    for k in sorted(by_prio):
        for p in PHASES:
            flat[f"prio{k}.{p}"] = by_prio[k][p] / counts[k]
    return FleetPhases(
        jobs=len(per_job),
        phase_seconds={p: agg[p] / wsum for p in PHASES},
        phase_by_priority=flat,
        dominant_phase=dict(sorted(dominant.items())),
    )


def analyze(records: Sequence[Dict[str, Any]]) -> FleetPhases:
    """Offline fleet report for ONE run's records: decomposition rollup plus
    the longest causal chain from the span graph."""
    from repro_torch.obs.spans import build_span_graph
    per_job = decompose(records)
    prio = {r["job"]: r.get("priority", 1) for r in records
            if r.get("kind") == "job_submit"}
    fleet = rollup(per_job, prio)
    fleet.longest_causal_chain = build_span_graph(records) \
        .longest_causal_chain()
    return fleet


def reconcile(records: Sequence[Dict[str, Any]], rel_tol: float = 1e-3
              ) -> List[str]:
    """Check that every completed job's phase sum equals its makespan to
    ``rel_tol`` (<0.1% by default).  Returns violation strings (empty = OK).
    Used by :mod:`repro_torch.obs.audit` as the ``phase_reconciliation`` check."""
    submits = {r["job"]: r["t"] for r in records
               if r.get("kind") == "job_submit"}
    ends = {r["job"]: r["t"] for r in records
            if r.get("kind") == "job_complete"}
    violations = []
    for job_id, ph in decompose(records).items():
        if job_id not in submits or job_id not in ends:
            continue
        makespan = ends[job_id] - submits[job_id]
        total = sum(ph.values())
        if abs(total - makespan) > max(1e-6, rel_tol * abs(makespan)):
            violations.append(
                f"{job_id}: phases sum to {total:.3f}s but makespan is "
                f"{makespan:.3f}s")
    return violations
