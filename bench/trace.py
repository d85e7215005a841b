"""The traced window: ``torch.profiler`` over the card's activity only, and
its reduction to what the per-layer readers and the breakdown need.

Device intervals are the card's kernels, copies and sets.  The host side is
not traced op by op: a full-size MoE step runs some hundreds of thousands
of host ops (22,000 a step at two layers, counted on the CPU), too many to
hold for a whole window.  The driver notes its own spans instead
(``bench.step``, ``bench.rescale``), on ``time.time_ns()``, the clock the
profiler's events carry.  An idle gap is a stretch of the window in which
no device interval runs, named by the span it falls in.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

TOP = 10
SHORT_GAP_NS = 10_000           # gaps shorter than this are summed unnamed


class Window:
    """Profile the card inside ``with``; ``reduce()`` afterwards."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self._prof.__exit__(*exc)

    def reduce(self, spans: List[Tuple[int, int, str]], t0_ns: int, t1_ns: int) -> dict:
        """``spans``: the driver's (start ns, end ns, name); the measured
        window is [t0_ns, t1_ns] on the same clock."""
        from torch.autograd import DeviceType
        device = [(e.start_ns(), e.end_ns(), e.name())
                  for e in self._prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA and e.end_ns() > e.start_ns()]
        return reduce_events(device, spans, t0_ns, t1_ns)


def _union(intervals: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _span_at(spans: List[Tuple[int, int, str]], t: int) -> str:
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return spans[i][2] if i >= 0 and spans[i][1] >= t else "between spans"


def reduce_events(device, spans, t0_ns: int, t1_ns: int) -> dict:
    """``device``/``spans``: [(start ns, end ns, name)]; the window is
    [t0_ns, t1_ns].  Spans do not overlap."""
    spans = sorted(spans)
    busy = _union([(s, e) for s, e, _ in device], t0_ns, t1_ns)
    by_kernel: Dict[str, float] = defaultdict(float)
    for s, e, name in device:
        if t0_ns <= s and e <= t1_ns:
            by_kernel[name] += (e - s) / 1e9
    edges = [t0_ns] + [x for iv in busy for x in iv] + [t1_ns]
    idle: Dict[str, float] = defaultdict(float)
    for s, e in zip(edges[::2], edges[1::2]):
        if e - s >= SHORT_GAP_NS:
            idle[_span_at(spans, (s + e) // 2)] += (e - s) / 1e9
        elif e > s:
            idle[f"gaps under {SHORT_GAP_NS // 1000} us"] += (e - s) / 1e9
    top = lambda d: [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"window_s": (t1_ns - t0_ns) / 1e9, "busy_s": sum(e - s for s, e in busy) / 1e9,
            "device_ops": top(by_kernel), "idle_gaps": top(idle),
            "kernels": sorted(device), "spans": spans}


def within(kernels: List[Tuple[int, int, str]], start: int, end: int) -> List[tuple]:
    """The kernels that start inside [start, end] (``kernels`` sorted)."""
    lo = bisect.bisect_left(kernels, (start,))
    hi = bisect.bisect_right(kernels, (end, float("inf")))
    return kernels[lo:hi]
