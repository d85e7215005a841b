"""Deterministic zero-dep self-profiler for the simulator hot path.

Copy of ``repro.obs.profile`` (framework-free).

An event-loop refactor needs to know where simulator wall-clock goes
*before* it starts moving code: per-event-kind handler cost, heap-op cost,
metrics-tick cost, tracer-site cost.  cProfile answers that but
distorts the loop (~3-5x) and drags in pstats; this profiler is two
``perf_counter`` calls per timed region and a dict update, cheap enough to
leave on for a whole benchmark rung.

Wiring mirrors the tracer exactly:

- ``Simulator(..., profiler=SimProfiler())`` times every dispatched event
  by kind; ``EventQueue`` picks the profiler up from the simulator and times
  heap pushes;
- :func:`install_profiler` sets a process-wide default that simulators
  adopt at construction, so whole scripts profile without signature changes;
- off is free: every site guards with ``if prof is not None``.

``report()`` renders the accumulators in the shape of the ``profile``
section of the JAX package's ``BENCH_simcore.json``, which
:mod:`repro_torch.obs.watchdog` diffs against a baseline.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, Optional


class SimProfiler:
    """Accumulating profiler: ``event(kind, dt)`` per dispatched event,
    ``section(name, dt)`` for named regions (heap ops, metrics ticks)."""

    __slots__ = ("_events", "_sections", "wall_s")

    def __init__(self):
        self._events: Dict[str, list] = {}     # kind -> [count, total_s]
        self._sections: Dict[str, list] = {}   # name -> [count, total_s]
        self.wall_s = 0.0                      # whole-run wall (set by runner)

    # -- hot-path accumulators (no allocation after first sight of a key) ----
    def event(self, kind: str, dt: float) -> None:
        cell = self._events.get(kind)
        if cell is None:
            cell = self._events[kind] = [0, 0.0]
        cell[0] += 1
        cell[1] += dt

    def section(self, name: str, dt: float) -> None:
        cell = self._sections.get(name)
        if cell is None:
            cell = self._sections[name] = [0, 0.0]
        cell[0] += 1
        cell[1] += dt

    @contextlib.contextmanager
    def timed(self, name: str) -> Iterator[None]:
        """Convenience for cold(ish) regions; hot paths inline the two
        ``perf_counter`` calls instead."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.section(name, time.perf_counter() - t0)

    # -- results -------------------------------------------------------------
    @staticmethod
    def _render(table: Dict[str, list]) -> Dict[str, Dict[str, float]]:
        out = {}
        for name in sorted(table, key=lambda k: -table[k][1]):
            count, total = table[name]
            out[name] = {
                "count": count,
                "total_s": round(total, 6),
                "mean_us": round(total / count * 1e6, 3) if count else 0.0,
            }
        return out

    def report(self) -> Dict[str, Any]:
        events = self._render(self._events)
        handled = sum(c[1] for c in self._events.values())
        n_events = sum(c[0] for c in self._events.values())
        return {
            "events": events,
            "sections": self._render(self._sections),
            "events_total": n_events,
            "handler_s": round(handled, 6),
            "wall_s": round(self.wall_s, 6),
            # loop overhead = wall not attributable to handlers/sections;
            # negative only if wall_s was never set
            "unattributed_s": round(
                max(0.0, self.wall_s - handled
                    - sum(c[1] for c in self._sections.values())), 6)
            if self.wall_s else 0.0,
        }

    def merge(self, other: "SimProfiler") -> None:
        """Fold another profiler's accumulators into this one (several runs
        of one benchmark rung -> one report)."""
        for kind, (count, total) in other._events.items():
            cell = self._events.setdefault(kind, [0, 0.0])
            cell[0] += count
            cell[1] += total
        for name, (count, total) in other._sections.items():
            cell = self._sections.setdefault(name, [0, 0.0])
            cell[0] += count
            cell[1] += total
        self.wall_s += other.wall_s


_CURRENT: Optional[SimProfiler] = None


def current_profiler() -> Optional[SimProfiler]:
    """The process-installed profiler, or None.  Simulators default to this
    at construction (mirroring :func:`repro_torch.obs.trace.current_tracer`), so
    an installed profiler reaches every nested simulation."""
    return _CURRENT


@contextlib.contextmanager
def install_profiler(prof: SimProfiler) -> Iterator[SimProfiler]:
    """Make ``prof`` the process default for the duration of the block."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = prof
    try:
        yield prof
    finally:
        _CURRENT = prev
