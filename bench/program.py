"""The port's own spans and counters (``repro_torch.obs.device_spans``) of
a traced window, for the per-layer readers of ``source: program_span``.

The port records them while a ``torch.profiler`` runs, as it does over the
traced window, into its profiled recorder, on ``time.time_ns()``, the clock
of the profiler's device events and of the driver's spans.  The first reader
of a run flushes that recorder (one device sync, after the window) and
keeps the result on the run as ``program``: ``{"spans": [...],
"counters": {...}}``, or None where the run was not traced, the port has no
such recorder, or it recorded no span.  Each span carries ``name``,
``phase`` (``forward``, ``recompute`` or ``backward``), ``t0_ns``,
``t1_ns`` and ``device_s`` (None off the card)."""
from __future__ import annotations

from typing import Optional


def of(run) -> Optional[dict]:
    if not hasattr(run, "program"):
        run.program = _flush() if getattr(run, "trace", None) is not None else None
    return run.program


def _flush() -> Optional[dict]:
    try:
        from repro_torch.obs import device_spans
    except ImportError:
        return None
    rec = getattr(device_spans, "profiled_recorder", lambda: None)()
    if rec is None:
        return None
    out = rec.flush()
    return out if out["spans"] else None


def device_s(run, name: str, phase: Optional[str] = None) -> Optional[float]:
    """Device seconds of the spans named ``name`` (in ``phase``, or in every
    phase) over the window; None where the run holds no such span, or one
    without device time."""
    program = of(run)
    if not program:
        return None
    got = [s["device_s"] for s in program["spans"]
           if s["name"] == name and phase in (None, s["phase"])]
    if not got or None in got:
        return None
    return sum(got)


def s_per_step(run, name: str, phase: Optional[str] = None) -> Optional[float]:
    """``device_s`` over the window's ``trainer.step`` spans."""
    total = device_s(run, name, phase)
    steps = total is not None and sum(s["name"] == "trainer.step"
                                      for s in run.program["spans"])
    return total / steps if steps else None


def counters(run) -> dict:
    """The window's counters; empty where the run holds none."""
    program = of(run)
    return program["counters"] if program else {}
