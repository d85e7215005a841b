"""Streaming statistics: P2 quantiles, counters, per-priority latency.

Copy of ``repro.obs.stats`` (framework-free).

:class:`P2Quantile` is the Jain & Chlamtac (CACM 1985) P-squared estimator:
one quantile in O(1) memory (five markers), no sample buffer — so every
run can afford p50/p95/p99 of response/completion/queue-wait per
priority class, always on, without holding per-job latency arrays.

:class:`Counters` is the flat counter registry the operator's control loop
ticks (ticks, rescales, migrations, failures, completions).

:class:`LatencyRecorder` folds job lifecycle timestamps into the estimators
and renders them as the flat ``ScheduleMetrics.percentiles`` mapping
(``resp_p99``, ``wait_p95_prio5``, ...).
"""
from __future__ import annotations

import bisect
from typing import TYPE_CHECKING, Dict, Optional, Tuple

if TYPE_CHECKING:       # repro_torch.core imports this module: no import cycle
    from repro_torch.core.job import JobState

# bound on first use by observe_completed (import cycle: repro_torch.core.job
# imports this module at definition time)
completion_time = response_time = None


class P2Quantile:
    """Single-quantile P-squared estimator.  Exact for the first five
    observations; afterwards five markers track (min, q/2, q, (1+q)/2, max)
    with parabolic (fallback linear) height adjustment.

    ``observe`` runs 18x per completed job (3 metrics x 2 priority keys x
    3 quantiles) on the JAX package's simulator hot path, where the textbook form's
    array-indexing loops were the single largest profiler line.  Two
    transformations keep it cheap without changing a single float op:

    - the five-marker update is fully unrolled — scalar slots and
      straight-line arithmetic, no marker arrays or helper calls.
      ``pos[0]``/``npos[0]`` are pinned at 1.0 by construction (marker 0
      never moves, ``dn[0] == 0``) and are folded into the constants;
    - observations land in a small bounded buffer (``observe`` is one list
      append) and are folded in batches by :meth:`_drain`, which keeps the
      whole estimator state in locals across the batch — per-observation
      attribute traffic and call dispatch amortize away.  The sequence the
      marker update sees is unchanged, so results are bit-identical to the
      one-at-a-time form.  Memory stays O(1): the buffer never exceeds
      ``_DRAIN_AT`` floats."""

    _DRAIN_AT = 64                     # buffered observations per fold

    __slots__ = ("q", "_n", "_small", "_buf",
                 "_h0", "_h1", "_h2", "_h3", "_h4",
                 "_p1", "_p2", "_p3", "_p4",
                 "_q1", "_q2", "_q3", "_q4",
                 "_d1", "_d2", "_d3")

    def __init__(self, q: float):
        assert 0.0 < q < 1.0, q
        self.q = q
        self._n = 0
        self._small = []                # first five observations, sorted
        self._buf = []                  # not-yet-folded observations
        self._p1, self._p2, self._p3, self._p4 = 2.0, 3.0, 4.0, 5.0
        self._q1 = 1.0 + 2.0 * q       # desired marker positions
        self._q2 = 1.0 + 4.0 * q
        self._q3 = 3.0 + 2.0 * q
        self._q4 = 5.0
        self._d1 = q / 2.0             # per-observation position increments
        self._d2 = q
        self._d3 = (1.0 + q) / 2.0

    def observe(self, x: float) -> None:
        buf = self._buf
        buf.append(x)
        if len(buf) >= self._DRAIN_AT:
            self._drain()

    def _drain(self) -> None:
        buf = self._buf
        if not buf:
            return
        self._buf = []
        self._absorb(buf)

    def _absorb(self, buf) -> None:
        """Fold a batch of observations (oldest first).  The caller owns
        ``buf`` and must have flushed ``_buf`` first — batches and single
        observations must land in arrival order."""
        n = self._n
        i = 0
        if n < 5:                      # exact phase: collect five, sorted
            small = self._small
            for x in buf:
                bisect.insort(small, x)
                n += 1
                i += 1
                if n == 5:
                    self._h0, self._h1, self._h2, self._h3, self._h4 = small
                    break
            if n < 5:
                self._n = n
                return
        h0, h1, h2, h3, h4 = self._h0, self._h1, self._h2, self._h3, self._h4
        p1, p2, p3, p4 = self._p1, self._p2, self._p3, self._p4
        q1, q2, q3 = self._q1, self._q2, self._q3
        d1, d2, d3 = self._d1, self._d2, self._d3
        for x in buf[i:] if i else buf:
            n += 1
            # locate the cell (clamping the extremes) and bump every marker
            # position above it
            if x < h0:
                h0 = x
                p1 += 1.0
                p2 += 1.0
                p3 += 1.0
            elif x >= h4:
                h4 = x
            elif x < h1:
                p1 += 1.0
                p2 += 1.0
                p3 += 1.0
            elif x < h2:
                p2 += 1.0
                p3 += 1.0
            elif x < h3:
                p3 += 1.0
            p4 += 1.0
            q1 += d1
            q2 += d2
            q3 += d3
            # -- marker 1 (neighbors: pos0 == 1.0, pos2) ----------------------
            d = q1 - p1
            if ((d >= 1.0 and p2 - p1 > 1.0)
                    or (d <= -1.0 and 1.0 - p1 < -1.0)):
                d = 1.0 if d > 0.0 else -1.0
                hp = h1 + d / (p2 - 1.0) * (
                    (p1 - 1.0 + d) * (h2 - h1) / (p2 - p1)
                    + (p2 - p1 - d) * (h1 - h0) / (p1 - 1.0))
                if not (h0 < hp < h2):
                    if d > 0.0:
                        hp = h1 + (h2 - h1) / (p2 - p1)
                    else:
                        hp = h1 - (h0 - h1) / (1.0 - p1)
                h1 = hp
                p1 += d
            # -- marker 2 -----------------------------------------------------
            d = q2 - p2
            if ((d >= 1.0 and p3 - p2 > 1.0)
                    or (d <= -1.0 and p1 - p2 < -1.0)):
                d = 1.0 if d > 0.0 else -1.0
                hp = h2 + d / (p3 - p1) * (
                    (p2 - p1 + d) * (h3 - h2) / (p3 - p2)
                    + (p3 - p2 - d) * (h2 - h1) / (p2 - p1))
                if not (h1 < hp < h3):
                    if d > 0.0:
                        hp = h2 + (h3 - h2) / (p3 - p2)
                    else:
                        hp = h2 - (h1 - h2) / (p1 - p2)
                h2 = hp
                p2 += d
            # -- marker 3 -----------------------------------------------------
            d = q3 - p3
            if ((d >= 1.0 and p4 - p3 > 1.0)
                    or (d <= -1.0 and p2 - p3 < -1.0)):
                d = 1.0 if d > 0.0 else -1.0
                hp = h3 + d / (p4 - p2) * (
                    (p3 - p2 + d) * (h4 - h3) / (p4 - p3)
                    + (p4 - p3 - d) * (h3 - h2) / (p3 - p2))
                if not (h2 < hp < h4):
                    if d > 0.0:
                        hp = h3 + (h4 - h3) / (p4 - p3)
                    else:
                        hp = h3 - (h2 - h3) / (p2 - p3)
                h3 = hp
                p3 += d
        self._n = n
        self._h0, self._h1, self._h2, self._h3, self._h4 = h0, h1, h2, h3, h4
        self._p1, self._p2, self._p3, self._p4 = p1, p2, p3, p4
        self._q1, self._q2, self._q3 = q1, q2, q3
        self._q4 += float(len(buf) - i)

    @property
    def count(self) -> int:
        return self._n + len(self._buf)

    def value(self) -> float:
        self._drain()
        if self._n == 0:
            return 0.0
        if self._n <= 5:                # exact empirical quantile
            idx = max(0, min(self._n - 1, int(self.q * self._n)))
            return self._small[idx]
        return self._h2


class Counters:
    """Flat monotonic counter registry."""

    __slots__ = ("_c",)

    def __init__(self):
        self._c: Dict[str, int] = {}

    def inc(self, name: str, n: int = 1) -> None:
        c = self._c
        c[name] = c.get(name, 0) + n

    def get(self, name: str) -> int:
        return self._c.get(name, 0)

    def as_dict(self) -> Dict[str, int]:
        return dict(self._c)


#: latency metrics tracked per job: response (submit -> first start),
#: completion (submit -> end), queue wait (total time spent QUEUED)
QUANTILES = (0.5, 0.95, 0.99)


class LatencyRecorder:
    """Per-priority-class streaming latency percentiles.

    ``mark_queued``/``mark_started`` bracket QUEUED episodes (initial queueing
    and preempt -> resume gaps both count as queue wait);
    ``observe_completed`` folds the finished job's response/completion/wait
    into the aggregate estimators and the job's priority-class estimators.
    """

    def __init__(self):
        # (metric, priority-or-None) -> {q: estimator}
        self._est: Dict[Tuple[str, Optional[int]],
                        Dict[float, P2Quantile]] = {}
        # priority -> ((buffer, estimators), ...) for resp/compl/wait: the
        # three quantile estimators of one metric see the SAME value stream,
        # so the hot path buffers each value once per metric and folds the
        # shared buffer into all three estimators when it fills
        self._fast: Dict[Optional[int], tuple] = {}
        self._queued_at: Dict[str, float] = {}
        self._wait: Dict[str, float] = {}
        self.completed = 0

    def mark_queued(self, job_id: str, t: float) -> None:
        self._queued_at.setdefault(job_id, t)

    def mark_started(self, job_id: str, t: float) -> None:
        q = self._queued_at.pop(job_id, None)
        if q is not None:
            self._wait[job_id] = self._wait.get(job_id, 0.0) + max(0.0, t - q)

    def observe_completed(self, job: "JobState") -> None:
        global completion_time, response_time
        if completion_time is None:     # deferred: repro_torch.core imports us
            from repro_torch.core.job import completion_time, response_time
        self.completed += 1
        resp = response_time(job)
        comp = completion_time(job)
        wait = self._wait.pop(job.job_id, 0.0)
        self._queued_at.pop(job.job_id, None)
        if resp is None or comp is None:    # never-started edge cases
            # single observations must not overtake buffered batches
            self._flush_pending()
            for prio in (None, job.spec.priority):
                self._feed(("resp", prio), resp)
                self._feed(("compl", prio), comp)
                self._feed(("wait", prio), wait)
            return
        for prio in (None, job.spec.priority):
            fast = self._fast.get(prio)
            if fast is None:
                per_metric = []
                for metric in ("resp", "compl", "wait"):
                    ests = self._est.get((metric, prio))
                    if ests is None:
                        ests = self._est[(metric, prio)] = {
                            q: P2Quantile(q) for q in QUANTILES}
                    per_metric.append(([], tuple(ests.values())))
                fast = self._fast[prio] = tuple(per_metric)
            (br, er), (bc, ec), (bw, ew) = fast
            br.append(resp)
            bc.append(comp)
            bw.append(wait)
            if len(br) >= 64:
                for buf, ests in fast:
                    for est in ests:
                        est._drain()    # older singles (fallback path) first
                        est._absorb(buf)
                    del buf[:]

    def _flush_pending(self) -> None:
        """Fold every buffered per-metric batch into its estimators."""
        for fast in self._fast.values():
            for buf, ests in fast:
                if buf:
                    for est in ests:
                        est._drain()
                        est._absorb(buf)
                    del buf[:]

    def _feed(self, key: Tuple[str, Optional[int]],
              x: Optional[float]) -> None:
        if x is None:
            return
        ests = self._est.get(key)
        if ests is None:
            ests = self._est[key] = {q: P2Quantile(q) for q in QUANTILES}
        for est in ests.values():
            est.observe(x)

    def percentile_fields(self) -> Dict[str, float]:
        """Flat mapping for ``ScheduleMetrics.percentiles``: ``resp_p99``
        (all classes) and ``resp_p99_prio<k>`` (one priority class), for
        each of resp/compl/wait x p50/p95/p99."""
        self._flush_pending()
        out: Dict[str, float] = {}
        for (metric, prio) in sorted(
                self._est, key=lambda k: (k[0], k[1] is not None, k[1] or 0)):
            suffix = "" if prio is None else f"_prio{prio}"
            for q, est in self._est[(metric, prio)].items():
                out[f"{metric}_p{int(round(q * 100))}{suffix}"] = est.value()
        return out
