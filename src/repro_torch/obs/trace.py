"""Structured JSONL flight recorder.

Copy of ``repro.obs.trace`` (framework-free), with its own process-wide
tracer: the port's live operator emits the same records as the JAX
package's, so one auditor reads both.

One :class:`Tracer` receives every span/event record a simulator (or the live
controller) emits: job lifecycle (submit -> queue -> start -> rescale ->
preempt -> resume -> complete, with slot deltas and overhead seconds), node
lifecycle (boot / kill / cordon / drain / removal), zone reclaims, itemized
cost events, and the decision-audit records of :mod:`repro_torch.obs.decisions`.

Records are flat JSON objects with two universal keys — ``kind`` (the record
type) and ``t`` (virtual time) — plus kind-specific fields.  The schema is
documented in README.md ("Observability") and consumed by the JAX
package's ``repro.obs.audit`` (invariant replay) and ``repro.obs.timeline``
(text Gantt), which read the port's records unchanged.

Disabled runs pay ~nothing: the default is the module-level
:data:`NULL_TRACER`, whose ``enabled`` is False so instrumented code guards
every emission with one attribute check (``if tracer.enabled: ...``).

Callers install a tracer process-wide with::

    with install(Tracer(path)):
        op = ElasticClusterController(...)   # picks it up via current_tracer()
        op.run()

so deep call stacks need no per-layer tracer threading.
"""
from __future__ import annotations

import contextlib
import json
from typing import Any, Dict, Iterator, List, Optional


class NullTracer:
    """No-op sink; ``enabled`` is False so hot paths skip record building."""

    enabled = False
    __slots__ = ()

    def emit(self, kind: str, t: float = 0.0, **fields) -> None:
        pass

    def next_run_id(self) -> int:
        return 0

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


#: process-wide default sink (see :func:`current_tracer`)
NULL_TRACER = NullTracer()


class Tracer:
    """JSONL sink.  With ``path`` records stream to disk; without one (or
    with ``keep=True``) they accumulate in ``records`` for in-process
    consumers (tests, the audit/timeline helpers).

    Emission is LAZY: the hot path appends one ``(kind, t, fields)`` tuple
    to a pending buffer; dict assembly, JSON serialization, and the file
    write happen per ``batch`` records (and at ``flush``/``close``/
    ``records`` access), amortizing the serialization cost out of the
    scheduler's control loop.  Callers must therefore pass fields the caller
    will not mutate afterwards — every instrumentation site in the repo
    already passes fresh scalars/copies (``dict(victims)``, ``list(...)``).
    """

    enabled = True

    def __init__(self, path: Optional[str] = None, *,
                 keep: Optional[bool] = None, batch: int = 1024):
        self.path = path
        self._fh = open(path, "w") if path else None
        keep = keep if keep is not None else path is None
        self._records: Optional[List[Dict[str, Any]]] = [] if keep else None
        self._pending: List[tuple] = []
        self._batch = batch
        self._runs = 0

    def next_run_id(self) -> int:
        """Monotone run id so several simulations can share one file; the
        auditor/timeline split the stream on ``run_start`` records."""
        self._runs += 1
        return self._runs

    def emit(self, kind: str, t: float = 0.0, **fields) -> None:
        self._pending.append((kind, t, fields))
        if len(self._pending) >= self._batch:
            self._drain()

    def _drain(self) -> None:
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        recs: List[Dict[str, Any]] = []
        for kind, t, fields in pending:
            rec = {"kind": kind, "t": t}
            rec.update(fields)
            recs.append(rec)
        if self._fh is not None:
            dumps = json.dumps
            self._fh.write("".join(dumps(r, separators=(",", ":")) + "\n"
                                   for r in recs))
        if self._records is not None:
            self._records.extend(recs)

    @property
    def records(self) -> Optional[List[Dict[str, Any]]]:
        """Accumulated records (None when streaming to disk without
        ``keep``).  Accessing drains the pending buffer first, so in-process
        consumers always see a complete, ordered list."""
        self._drain()
        return self._records

    def flush(self) -> None:
        self._drain()
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        self._drain()
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @staticmethod
    def load(path: str) -> List[Dict[str, Any]]:
        with open(path) as fh:
            return [json.loads(line) for line in fh if line.strip()]


_CURRENT: Optional[Tracer] = None


def current_tracer():
    """The process-installed tracer, or :data:`NULL_TRACER`.  The operator
    defaults to this at construction, so ``install`` wraps whole scripts
    without touching their signatures."""
    return _CURRENT if _CURRENT is not None else NULL_TRACER


@contextlib.contextmanager
def install(tracer: Tracer) -> Iterator[Tracer]:
    """Make ``tracer`` the process default for the duration of the block."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = tracer
    try:
        yield tracer
    finally:
        _CURRENT = prev
