"""Spans and counters of the port's training path, on the device trace's
clock.

``ElasticTrainer.step`` and ``rescale``, each decoder layer, the MoE layer
and the host lane open named spans here (``trainer.*``, ``model.layer``,
``model.moe.*``, ``rescale.*``) and add to named counters (``moe.*``,
``host_lane.*``).  An operator installs a :class:`SpanRecorder` around
the calls it wants to see::

    rec = SpanRecorder(device)
    with install(rec):
        trainer.step()
        trainer.rescale(slots)
    out = rec.flush()      # {"spans": [...], "counters": {...}}

Or runs the trainer under ``torch.profiler``: ``ElasticTrainer.step`` and
``rescale`` first call :func:`follow_profiler`, which, while a profiler runs
and no recorder was installed by hand, makes the process's profiled
recorder (:func:`profiled_recorder`) the current one, so that a profiled
window's spans lie on the profiler's own clock beside its device events.

Off is the default: :func:`current_recorder` is :data:`NULL_RECORDER`,
whose ``enabled`` is False, and :func:`span` then hands out one shared
no-op context manager: no allocation, no clock read.

A span records its name, ``t0_ns``/``t1_ns`` on ``time.time_ns()`` (the
clock ``torch.profiler``'s device events carry), its id and its parent's
(the innermost open span of its own thread, else the open
``trainer.backward``: on a card the backward runs on autograd's device
thread), the step index every span of one step shares, its phase (see
:func:`phase`), and its attributes (``attrs``, such as a shard).  On a CUDA
recorder it also records a start and an end ``torch.cuda.Event`` on the
current stream, taken from the recorder's pool (``reserve`` fills it ahead;
``flush()`` gives each pair back once read, and so does each opening of a
``trainer.step`` for the pairs the card has passed, so a window makes one
step's pairs and reuses them); ``flush()`` synchronises
once and turns each pair into ``device_s``, the stream's time between them.
Its ``host_s`` (:attr:`Span.seconds`) comes from the monotonic
``time.perf_counter_ns()``, read beside ``time_ns()``.  A counter adds
Python ints or device tensors; tensors are summed on the device at
``flush()``, so counting adds no sync to a step.

Apart from the flight recorder (``obs.trace``): those records carry the
operator's clock and are held record for record to the JAX package's, which
has no counterpart of these.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch

BACKWARD = "trainer.backward"       # parent of spans opened on a thread with none open
STEP = "trainer.step"               # its opening recycles the passed event pairs


def phase() -> str:
    """The phase autograd's own state gives: ``forward`` outside a backward
    pass; inside one, ``recompute`` where grad mode is on (a checkpointed
    layer's forward run again) and ``backward`` where it is off (a
    Function's backward).  Right on the CPU, where the backward runs on the
    calling thread, and on a card, where it runs on autograd's thread."""
    if torch._C._current_graph_task_id() == -1:
        return "forward"
    return "recompute" if torch.is_grad_enabled() else "backward"


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


#: the one no-op every ``span()`` returns while no recorder is installed
NO_SPAN = _NoSpan()


class Span:
    """One span: reads the clock on enter and exit; recorded by ``rec``
    when one is given."""

    __slots__ = ("rec", "name", "attrs", "id", "parent", "step", "phase",
                 "t0_ns", "t1_ns", "c0_ns", "c1_ns", "events", "device_s")

    def __init__(self, rec: Optional["SpanRecorder"], name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs
        self.id = self.parent = self.step = self.phase = self.events = None
        self.device_s: Optional[float] = None
        self.t0_ns = self.t1_ns = self.c0_ns = self.c1_ns = 0

    def __enter__(self) -> "Span":
        if self.rec is not None:
            self.rec._open(self)
        self.t0_ns, self.c0_ns = time.time_ns(), time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.c1_ns, self.t1_ns = time.perf_counter_ns(), time.time_ns()
        if self.rec is not None:
            self.rec._close(self)
        return None

    @property
    def seconds(self) -> float:
        """Seconds from enter to exit on the monotonic clock."""
        return (self.c1_ns - self.c0_ns) / 1e9


class NullRecorder:
    """The default: records nothing (every site checks ``enabled`` first)."""

    enabled = False
    __slots__ = ()


NULL_RECORDER = NullRecorder()


class SpanRecorder:
    """Keeps every span and counter in memory until ``flush()``.  On a card,
    ``reserve`` event pairs are made (and recorded once, so the card creates
    them) ahead, for the spans of a window to take without making any."""

    enabled = True

    def __init__(self, device="cpu", reserve: int = 0):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._tls = threading.local()
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._pool: List[tuple] = []
        if self._cuda:
            for _ in range(reserve):
                pair = self._new_events()
                pair[0].record()
                pair[1].record()
                self._pool.append(pair)
        self._reset()

    @staticmethod
    def _new_events() -> tuple:
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def _reset(self):
        self._closed: List[Span] = []
        self._read = 0                  # closed spans up to here were recycled
        self._ints: Dict[str, int] = {}
        self._tensors: Dict[str, List[torch.Tensor]] = {}
        self._backward: Optional[Span] = None
        self.step: Optional[int] = None

    def span(self, name: str, step: Optional[int] = None,
             attrs: Optional[dict] = None) -> Span:
        """A span to enter; ``step`` sets the step index of it and of every
        span opened after it."""
        if step is not None:
            self.step = step
        return Span(self, name, attrs or {})

    def count(self, name: str, value) -> None:
        """Add ``value``, a Python int or a device tensor, to counter ``name``."""
        with self._lock:
            if isinstance(value, torch.Tensor):
                self._tensors.setdefault(name, []).append(value.detach().reshape(()))
            else:
                self._ints[name] = self._ints.get(name, 0) + int(value)

    def _stack(self) -> List[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _open(self, s: Span) -> None:
        stack = self._stack()
        parent = stack[-1] if stack else self._backward
        s.id, s.parent = next(self._ids), parent.id if parent is not None else None
        s.step, s.phase = self.step, phase()
        if s.name == BACKWARD:
            self._backward = s
        stack.append(s)
        if self._cuda:
            if s.name == STEP:
                self._recycle()
            try:
                s.events = self._pool.pop()
            except IndexError:
                s.events = self._new_events()
            s.events[0].record()

    def _close(self, s: Span) -> None:
        if s.events is not None:
            s.events[1].record()
        self._stack().pop()             # spans close in the order ``with`` gives
        if self._backward is s:
            self._backward = None
        with self._lock:
            self._closed.append(s)

    def _recycle(self) -> None:
        """Read the device time of each span closed since the last call whose
        end the card has passed, and give its pair back to the pool.  Called
        as a step opens, after the last step's reads drained the card."""
        with self._lock:
            fresh = self._closed[self._read:]
            self._read = len(self._closed)
        for s in fresh:
            if s.events is not None and s.events[1].query():
                s.device_s = s.events[0].elapsed_time(s.events[1]) / 1e3
                self._pool.append(s.events)
                s.events = None

    def flush(self) -> dict:
        """Every closed span (in order of start) and every counter since the
        last flush; forgets them.  On a card, synchronises once."""
        if self._cuda:
            torch.cuda.synchronize(self.device)
        with self._lock:
            closed, ints, tensors = self._closed, self._ints, self._tensors
            self._reset()
        spans = []
        for s in sorted(closed, key=lambda s: (s.t0_ns, s.id)):
            device_s = s.device_s
            if s.events is not None:
                device_s = s.events[0].elapsed_time(s.events[1]) / 1e3
                self._pool.append(s.events)
            spans.append({**s.attrs, "name": s.name, "id": s.id, "parent": s.parent,
                          "step": s.step, "phase": s.phase, "t0_ns": s.t0_ns,
                          "t1_ns": s.t1_ns, "host_s": s.seconds, "device_s": device_s})
        counters = dict(ints)
        for name, ts in tensors.items():
            counters[name] = counters.get(name, 0) + int(torch.stack(ts).sum())
        return {"spans": spans, "counters": counters}


_CURRENT = NULL_RECORDER
_PROFILED: Optional[SpanRecorder] = None


def current_recorder():
    """The process-installed recorder, or :data:`NULL_RECORDER`."""
    return _CURRENT


@contextlib.contextmanager
def install(recorder) -> Iterator:
    """Make ``recorder`` the process default for the duration of the block."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = recorder
    try:
        yield recorder
    finally:
        _CURRENT = prev


def follow_profiler(device) -> None:
    """While a ``torch.profiler`` runs and no recorder was installed by hand,
    make the profiled recorder (made for ``device`` on first use) the
    current one; once the profiler has stopped, take it down again.  Its
    spans and counters stay in it until flushed."""
    global _CURRENT, _PROFILED
    if torch.autograd.profiler._is_profiler_enabled:
        if _CURRENT is NULL_RECORDER:
            if _PROFILED is None:
                _PROFILED = SpanRecorder(device)
            _CURRENT = _PROFILED
    elif _CURRENT is _PROFILED is not None:
        _CURRENT = NULL_RECORDER


def profiled_recorder() -> Optional[SpanRecorder]:
    """The recorder :func:`follow_profiler` installs, or None before a
    profiled call has made it."""
    return _PROFILED


def span(name: str, step: Optional[int] = None, attrs: Optional[dict] = None):
    """A context manager over the work named ``name``, with the attributes
    ``attrs``: :data:`NO_SPAN` while no recorder is installed."""
    rec = _CURRENT
    return rec.span(name, step, attrs) if rec.enabled else NO_SPAN


def timed(name: str, step: Optional[int] = None, attrs: Optional[dict] = None) -> Span:
    """A span that reads the clock whether or not a recorder is installed,
    for callers that keep its ``seconds`` (``RescaleTimings``)."""
    rec = _CURRENT
    return rec.span(name, step, attrs) if rec.enabled else Span(None, name, attrs or {})


def count(name: str, value) -> None:
    """Add ``value`` to counter ``name`` of the installed recorder, if any."""
    rec = _CURRENT
    if rec.enabled:
        rec.count(name, value)
