"""Tiny deterministic event queue (virtual or wall clock).

Copy of ``repro.core.events`` (framework-free).

Hot-path notes (the fleet-scale refactor): :class:`Event` is a plain
``__slots__`` class with a hand-rolled ``__lt__`` (a dataclass with
``order=True`` builds a comparison tuple per heap sift), the queue can
drain every event sharing the earliest timestamp in one pass
(:meth:`EventQueue.pop_batch`), and events invalidated by a rescale can be
:meth:`cancelled <EventQueue.cancel>` in place — the heap drops the
tombstone at pop time for the cost of one attribute check instead of a
full dispatch.  ``stale_dropped`` counts those drops (surfaced as the
``stale_events`` counter): how much dead weight the heap carried.
"""
from __future__ import annotations

import heapq
import math
import itertools
from time import perf_counter
from typing import Any, List, Optional

#: default tiebreak: sorts AFTER any finite submit key, so the same-time
#: semantics are "arrivals first": every submit at time t is processed
#: before any other event at t (a tick or kill landing exactly on an
#: arrival timestamp sees that arrival).  Default-keyed events keep plain
#: insertion order among themselves.  Note this is a (deliberate) semantic
#: change from the pre-tiebreak seq-only ordering in the rare case where a
#: non-submit event was pushed before submit() was called with the same
#: timestamp (e.g. the autoscaler's t=0 bootstrap tick now runs after t=0
#: arrivals instead of seeing an empty queue).
_LAST = (math.inf,)

#: kind a cancelled (tombstoned) event carries while it waits in the heap
_CANCELLED = "__cancelled__"


class Event:
    __slots__ = ("time", "tiebreak", "seq", "kind", "payload")

    def __init__(self, time: float, tiebreak: tuple = _LAST, seq: int = 0,
                 kind: str = "", payload: Any = None):
        self.time = time
        # orders same-time events BEFORE insertion order.  Simulator.submit
        # passes (-priority, job_id) so bursty arrivals that collapse onto one
        # timestamp process in a canonical order no matter the order submit()
        # was called in (trace replay is insertion-agnostic); every other
        # event kind keeps plain insertion order via the _LAST sentinel.
        self.tiebreak = tiebreak
        self.seq = seq
        self.kind = kind
        self.payload = payload

    def __lt__(self, other: "Event") -> bool:
        if self.time != other.time:
            return self.time < other.time
        if self.tiebreak != other.tiebreak:
            return self.tiebreak < other.tiebreak
        return self.seq < other.seq

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Event(t={self.time}, kind={self.kind!r}, seq={self.seq}, "
                f"payload={self.payload!r})")


class EventQueue:
    def __init__(self):
        self._heap: List[Event] = []
        self._count = itertools.count()
        self._cancelled = 0           # tombstones still sitting in the heap
        #: cancelled events silently dropped at pop time so far
        self.stale_dropped = 0
        # optional repro_torch.obs.profile.SimProfiler: the owning simulator wires
        # its profiler in so heap pushes show up as a "heap_push" section
        self.profiler = None

    def push(self, time: float, kind: str, payload: Any = None,
             tiebreak: tuple = _LAST) -> Event:
        ev = Event(time, tiebreak, next(self._count), kind, payload)
        prof = self.profiler
        if prof is None:
            heapq.heappush(self._heap, ev)
        else:
            t0 = perf_counter()
            heapq.heappush(self._heap, ev)
            prof.section("heap_push", perf_counter() - t0)
        return ev

    def cancel(self, ev: Event) -> None:
        """Invalidate an event in place (O(1)); the heap drops it at pop
        time for one attribute check instead of a full dispatch.  Safe on an
        already-popped event (the tombstone is simply never seen again)."""
        if ev.kind is not _CANCELLED:
            ev.kind = _CANCELLED
            self._cancelled += 1

    def _popped(self, ev: Event) -> None:
        """A cancelled event left the heap without being delivered."""
        self._cancelled -= 1
        self.stale_dropped += 1

    def pop(self) -> Optional[Event]:
        heap = self._heap
        while heap:
            ev = heapq.heappop(heap)
            if ev.kind is not _CANCELLED:
                return ev
            self._popped(ev)
        return None

    def pop_batch(self, out: List[Event]) -> int:
        """Drain every live event sharing the earliest timestamp into
        ``out`` (cleared first), preserving heap order; returns the count.
        One heap pass per *timestamp* instead of per event lets the
        simulator run its per-timestamp bookkeeping once per batch."""
        out.clear()
        heap = self._heap
        while heap:
            ev = heapq.heappop(heap)
            if ev.kind is _CANCELLED:
                self._popped(ev)
                continue
            out.append(ev)
            t = ev.time
            while heap and heap[0].time == t:
                ev = heapq.heappop(heap)
                if ev.kind is _CANCELLED:
                    self._popped(ev)
                else:
                    out.append(ev)
            break
        return len(out)

    def peek_time(self) -> Optional[float]:
        heap = self._heap
        while heap and heap[0].kind is _CANCELLED:
            self._popped(heapq.heappop(heap))
        return heap[0].time if heap else None

    @property
    def stale_total(self) -> int:
        """Stale (cancelled) events this queue ever carried: tombstones
        already dropped plus those still waiting in the heap — the
        ``stale_events`` counter at run end."""
        return self.stale_dropped + self._cancelled

    def __len__(self) -> int:
        """Live (non-cancelled) events still queued."""
        return len(self._heap) - self._cancelled
