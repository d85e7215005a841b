"""Per-job and per-cluster cost accounting (paper premise: pay-as-you-go).

Copy of ``repro.cloud.cost`` (framework-free), line for line, so both
packages give bit-equal results on the same inputs.

:class:`CostAccountant` is a piecewise-constant integrator.  The cloud
simulator calls :meth:`advance` at every state-change boundary *before*
applying the change, so each elapsed interval is integrated under the rates
that actually held during it:

- total cost:  sum over billed nodes of slots x $/slot-hour, plus any
               inter-region transfer dollars
- used cost:   running-job slots x the capacity-weighted mean price of the
               currently billed capacity (blended rate)
- idle cost:   capacity total - used  (wasted-idle dollars: provisioned, not
               running; transfer dollars are neither idle nor used capacity)
- job cost:    each job's replicas x blended rate, accumulated over its life
- transfer:    $/GB for checkpoint data restored in a different REGION than
               it was written in (a preempted job resuming across a region
               boundary drags its checkpoint over the wire; intra-region
               restores are free) — itemized separately and per job
- preemption overhead: the slot-seconds a victim spends writing/restoring
               its disk checkpoint, priced at the blended rate — an
               ATTRIBUTION of capacity dollars already billed (a subset of
               used/idle), itemized per job so consumers (the spot-bidding
               risk ledger) never re-derive it; never added to total_cost

Attribution note: the counting simulator does not pin jobs to nodes, so jobs
pay the *blended* $/slot-hour of whatever capacity mix is live — a job running
during a spot-heavy period is cheap, the same job on pure on-demand is not.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List

from repro_torch.core.job import JobState


@dataclass(frozen=True)
class CostReport:
    total_cost: float               # $ billed: node capacity + transfer
    used_cost: float                # $ attributed to running job slots
    idle_cost: float                # $ of provisioned-but-unused slot time
    node_hours: float               # billed node-hours
    slot_hours: float               # billed slot-hours
    job_costs: Dict[str, float]     # job_id -> capacity $ attributed
    spot_preemptions: int           # nodes reclaimed by the spot market
    transfer_cost: float = 0.0      # $ of inter-region checkpoint transfer
    transfer_costs: Dict[str, float] = field(default_factory=dict)  # per job
    # preemption overhead: checkpoint write/restore slot-time priced at the
    # blended rate — attribution of already-billed capacity $, not additive
    preempt_overhead_cost: float = 0.0
    preempt_overhead_slot_s: float = 0.0  # victim slot-seconds of overhead
    preempt_overhead_costs: Dict[str, float] = field(default_factory=dict)

    @property
    def idle_fraction(self) -> float:
        """Share of CAPACITY dollars wasted idle — transfer spend is not
        capacity and must not dilute the denominator."""
        capacity = self.used_cost + self.idle_cost
        return self.idle_cost / capacity if capacity else 0.0

    def row(self) -> str:
        return (f"cost=${self.total_cost:8.4f} idle=${self.idle_cost:8.4f} "
                f"({self.idle_fraction:6.2%}) node_h={self.node_hours:6.2f} "
                f"spot_kills={self.spot_preemptions} "
                f"xfer=${self.transfer_cost:7.4f}")


class CostAccountant:
    def __init__(self):
        self._now = 0.0
        self._dollars_per_s = 0.0       # current billed capacity burn rate
        self._billed_slots = 0
        self._billed_nodes = 0
        self._job_alloc: Dict[str, int] = {}
        self.total_cost = 0.0
        self.used_cost = 0.0
        self.node_seconds = 0.0
        self.slot_seconds = 0.0
        self.job_costs: Dict[str, float] = defaultdict(float)
        self.spot_preemptions = 0
        self.transfer_cost = 0.0
        self.transfer_costs: Dict[str, float] = defaultdict(float)
        self.preempt_overhead_cost = 0.0
        self.preempt_overhead_slot_s = 0.0
        self.preempt_overhead_costs: Dict[str, float] = defaultdict(float)

    # -- integration ---------------------------------------------------------
    def advance(self, now: float) -> None:
        """Integrate the interval since the last boundary under the current
        rates.  MUST be called before any node or allocation change."""
        dt = now - self._now
        if dt <= 0.0:
            return
        self._now = now
        self.total_cost += self._dollars_per_s * dt
        self.node_seconds += self._billed_nodes * dt
        self.slot_seconds += self._billed_slots * dt
        if self._billed_slots:
            blended = self._dollars_per_s / self._billed_slots   # $/slot-s
            alloc_total = sum(r for r in self._job_alloc.values() if r > 0)
            # a spot kill can leave allocations transiently above billed
            # capacity (victims checkpoint before eviction completes); scale
            # attribution down so used_cost never exceeds total_cost and
            # idle = total - used stays a true identity
            scale = (min(1.0, self._billed_slots / alloc_total)
                     if alloc_total else 1.0)
            for job_id, replicas in self._job_alloc.items():
                if replicas > 0:
                    dollars = replicas * scale * dt * blended
                    self.job_costs[job_id] += dollars
                    self.used_cost += dollars

    def spend_through(self, now: float) -> float:
        """Projected total spend at ``now`` without mutating state."""
        return (self.total_cost + self.transfer_cost
                + self._dollars_per_s * max(0.0, now - self._now))

    # -- state changes (apply AFTER advance) ---------------------------------
    def node_up(self, node) -> None:
        self._dollars_per_s += node.slots * node.pool.price_per_slot_hour / 3600.0
        self._billed_slots += node.slots
        self._billed_nodes += 1

    def node_down(self, node, *, killed: bool = False) -> None:
        self._dollars_per_s -= node.slots * node.pool.price_per_slot_hour / 3600.0
        self._billed_slots -= node.slots
        self._billed_nodes -= 1
        if self._billed_nodes == 0:
            self._dollars_per_s = 0.0    # kill float residue
        if killed:
            self.spot_preemptions += 1

    def set_allocations(self, running_jobs: Iterable[JobState]) -> None:
        self._job_alloc = {j.job_id: j.replicas for j in running_jobs}

    def blended_slot_rate(self) -> float:
        """Current blended $/slot-second of the billed capacity (0 with
        nothing billed) — the rate preemption overhead and lost work are
        priced at."""
        return (self._dollars_per_s / self._billed_slots
                if self._billed_slots else 0.0)

    def bill_preempt_overhead(self, job_id: str, seconds: float,
                              replicas: int) -> float:
        """Attribute one checkpoint write (at preempt) or restore (at
        resume) to the victim: ``seconds`` of ``replicas`` slots at the
        blended rate.  Returns the dollars so callers (the spot-bidding
        ledger) can consume them without re-deriving."""
        dollars = seconds * max(0, replicas) * self.blended_slot_rate()
        self.preempt_overhead_cost += dollars
        self.preempt_overhead_slot_s += seconds * max(0, replicas)
        self.preempt_overhead_costs[job_id] += dollars
        return dollars

    def bill_transfer(self, job_id: str, data_bytes: float,
                      price_per_gb: float) -> float:
        """Bill one inter-region checkpoint restore: the job's checkpoint
        footprint crosses a region boundary at ``price_per_gb``."""
        dollars = data_bytes / 1e9 * price_per_gb
        self.transfer_cost += dollars
        self.transfer_costs[job_id] += dollars
        return dollars

    # -- reporting -----------------------------------------------------------
    def report(self) -> CostReport:
        return CostReport(
            total_cost=self.total_cost + self.transfer_cost,
            used_cost=self.used_cost,
            idle_cost=max(0.0, self.total_cost - self.used_cost),
            node_hours=self.node_seconds / 3600.0,
            slot_hours=self.slot_seconds / 3600.0,
            job_costs=dict(self.job_costs),
            spot_preemptions=self.spot_preemptions,
            transfer_cost=self.transfer_cost,
            transfer_costs=dict(self.transfer_costs),
            preempt_overhead_cost=self.preempt_overhead_cost,
            preempt_overhead_slot_s=self.preempt_overhead_slot_s,
            preempt_overhead_costs=dict(self.preempt_overhead_costs),
        )
