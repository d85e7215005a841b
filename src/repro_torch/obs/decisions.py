"""Decision-audit records: *why* the stack did what it did.

Copy of ``repro.obs.decisions`` (framework-free).  The port runs every
choice point below: ``admit``, ``redistribute`` and ``preempt_select`` in
the policy, the others in its cloud layer (``repro_torch.cloud``).

Every choice point in the scheduling stack can carry a :class:`DecisionLog`
(None by default — zero overhead when tracing is off).  A record names the
choice point, the verdict, the inputs that drove it, and the alternatives
that were considered and rejected:

====================  ======================================================
point                 emitted by
====================  ======================================================
``admit``             ``ElasticPolicy.on_new_job`` — immediate start /
                      shrink-pass / enqueue, with the dry-pass candidate list
``redistribute``      ``ElasticPolicy.on_job_complete`` — freed-slot grants
``preempt_select``    ``PreemptingPolicy.on_new_job`` — victim selection
``scale_up``          ``NodeAutoscaler._provision`` — pool preference order
                      and per-pool outcomes (budget / max_nodes)
``scale_down``        ``NodeAutoscaler.evaluate`` — drain victim + candidates
``bid_flip``          ``DemandAwareBidder.zone_quotas`` — a zone open<->closed
                      flip with the risk-vs-discount inputs that triggered it
====================  ======================================================

Records ride the same JSONL stream as the lifecycle spans (``kind:
"decision"``), so one trace file tells the whole story in time order.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional


class DecisionLog:
    """Thin adapter binding a choice point to a tracer.  Policies hold
    ``self.decisions = None`` until a traced run wires one in."""

    __slots__ = ("tracer",)

    def __init__(self, tracer):
        self.tracer = tracer

    def record(self, point: str, t: float, verdict: str, *,
               inputs: Optional[Dict[str, Any]] = None,
               alternatives: Optional[List[Dict[str, Any]]] = None) -> None:
        self.tracer.emit("decision", t=t, point=point, verdict=verdict,
                         inputs=inputs or {},
                         alternatives=alternatives or [])


def decision_records(records: Iterable[Dict[str, Any]],
                     point: Optional[str] = None) -> List[Dict[str, Any]]:
    """Filter a loaded trace down to decision records (optionally one point)."""
    return [r for r in records
            if r.get("kind") == "decision"
            and (point is None or r.get("point") == point)]
