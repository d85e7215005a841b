"""The comparison that decides ``correct`` for a training cell.

Both sides give the same readings (``reference.train``'s form): each step's
loss, each leaf's norm of the clipped first gradient (from the first
moment after step 1) and each leaf's norm of its change over the compared
steps.  These numbers come of them:

- ``loss_gap``: the largest relative gap of a step's loss, and
  ``first_loss_gap`` that of the first step alone;
- ``grad_gap``: the worst leaf's gap of gradient norms, over the larger of
  the reference's norm of that leaf and of the median leaf;
- ``update_gap``: the same of the change, leaving out the leaves whose
  reference gradient is under a thousandth of the median leaf's (rounding
  alone moves those under AdamW).

A number that is not finite fails; a leaf on one side only is a fault.
A cell's ``limits/<cell>.json`` says which of the numbers it compares.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict

NEGLIGIBLE_GRAD = 1e-3


def _leaf_gap(got: Dict[str, float], want: Dict[str, float], keys) -> float:
    if set(got) != set(want):
        return math.inf
    floor = statistics.median(want.values())
    gaps = [abs(got[k] - want[k]) / max(want[k], floor) for k in keys]
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def gaps(got: dict, want: dict) -> Dict[str, float]:
    losses = list(zip(got["losses"], want["losses"]))
    loss_gap = max(abs(a - b) / abs(b) for a, b in losses) if losses else math.inf
    if len(got["losses"]) != len(want["losses"]) or not math.isfinite(loss_gap):
        loss_gap = math.inf
    g = want["grad_norms"]
    floor = statistics.median(g.values())
    moving = [k for k in g if g[k] >= NEGLIGIBLE_GRAD * floor]
    first = abs(got["losses"][0] - want["losses"][0]) / abs(want["losses"][0])
    return {"loss_gap": loss_gap,
            "first_loss_gap": first if math.isfinite(first) else math.inf,
            "grad_gap": _leaf_gap(got["grad_norms"], g, g),
            "update_gap": _leaf_gap(got["update_norms"], want["update_norms"], moving)}


def verdict(found: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(name in found and found[name] <= limit for name, limit in limits.items())
