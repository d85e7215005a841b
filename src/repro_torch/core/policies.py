"""Priority-based elastic scheduling policy — paper Fig. 2 / Fig. 3, faithful.

The policy is pure decision logic over a :class:`Cluster` view; effects go
through the :class:`Actions` interface, implemented by both the discrete-event
simulator (virtual clock) and the live operator (real training jobs).  This
is what lets one implementation serve contributions C2 and C3.  Copy of
``repro.core.policies`` (framework-free); the port's simulator
(``repro_torch.core.simulator``) and live operator both drive it.

The published listing is garbled by PDF extraction; the JAX package's
tests/test_scheduler_policies.py pins each behavior of this reconstruction to
a sentence of the paper's prose.

The four evaluated schedulers (paper §4.3) are all this one policy:
    rigid-min   jobs submitted with min==max==min_replicas
    rigid-max   jobs submitted with min==max==max_replicas
    moldable    rescale_gap = +inf (size picked at launch, never rescaled)
    elastic     the full policy
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Protocol

from repro_torch.core.cluster import Cluster
from repro_torch.core.job import JobState, JobStatus


class Actions(Protocol):
    """Effect interface; implementations must update cluster accounting
    synchronously (create/shrink/expand return success).

    Placement contract: every replica an implementation grants must be backed
    by a concrete node-owned slot (``Cluster.place``) and every replica it
    revokes must free one (``Cluster.evict``) — both the simulator's
    ``_SimActions`` and the live operator's ``_LiveActions`` thread placement
    through this way, so node kills and drains displace exactly the jobs
    resident on the affected node.  ``create``/``expand`` may return False
    when capacity raced away (a cordon or spot kill between the policy's
    ``free_slots`` read and the call); the policy then re-enqueues."""

    def create(self, job: JobState, replicas: int) -> bool: ...
    def expand(self, job: JobState, replicas: int) -> bool: ...
    def shrink(self, job: JobState, replicas: int) -> bool: ...
    def enqueue(self, job: JobState) -> None: ...


@dataclass(frozen=True)
class PolicyConfig:
    rescale_gap: float = 180.0        # T_rescale_gap (paper §3.2.1)
    launcher_reserve: int = 0         # paper's `freeSlots - 1` (MPI launcher
    #                                   pod); 1 reproduces the paper exactly,
    #                                   0 is the accelerator default
    # Fig. 3's pseudocode redistributes ONLY the slots freed by the completing
    # job; slots that were already idle are never re-offered, which can strand
    # capacity forever (a queued job whose min exceeds every later completion
    # starves on an idle cluster).  True (default) offers freed + idle slots;
    # False is pseudocode-faithful.  See the policy tests.
    redistribute_idle: bool = True

    @classmethod
    def moldable(cls, **kw) -> "PolicyConfig":
        kw.setdefault("rescale_gap", math.inf)
        return cls(**kw)


class ElasticPolicy:
    #: lazy progress-sync hook (fleet-scale refactor): the simulator wires
    #: this to its ``_sync_progress`` at run start, and extension hooks that
    #: read simulator-owned job state (CostBenefitPolicy's ``work_remaining``
    #: checks) call it first.  The base policy never reads such state, so the
    #: event loop no longer syncs every running job on every submit/complete
    #: just in case a subclass might look.
    sync_job = None

    def __init__(self, cfg: PolicyConfig):
        self.cfg = cfg
        # decision-audit sink (repro_torch.obs.decisions.DecisionLog); None (the
        # default) records nothing — traced runs wire one in at run start
        self.decisions = None

    # -- extension hooks (see core/autoscale.py) ------------------------------
    def _priority(self, job: JobState, now: float) -> float:
        """Effective priority; AgingPolicy overrides (paper §3.2.2 'aging')."""
        return float(job.spec.priority)

    def _should_expand(self, job: JobState, new_replicas: int, now: float
                       ) -> bool:
        """CostBenefitPolicy overrides (paper §6: expansion must pay for its
        rescale overhead)."""
        return True

    def _should_shrink(self, job: JobState, new_replicas: int, now: float
                       ) -> bool:
        """CostBenefitPolicy overrides (paper §6: a nearly-finished job should
        run to completion instead of being shrunk)."""
        return True

    # -- helpers ------------------------------------------------------------
    def _sorted_desc(self, jobs, now: float):
        # fast path (fleet-scale refactor): with the base static priority the
        # key equals JobState.sort_key, and every caller passes a Cluster
        # query result (running/queued/all_schedulable) that is already in
        # that exact order — skip the O(n log n) re-sort per event.  Dynamic
        # priorities (AgingPolicy) override _priority and take the sort.
        if type(self)._priority is ElasticPolicy._priority:
            return jobs
        return sorted(jobs, key=lambda j: (-self._priority(j, now),
                                           j.spec.submit_time, j.spec.job_id))

    def _avail(self, cluster: Cluster) -> int:
        return cluster.free_slots - self.cfg.launcher_reserve

    def _gap_ok(self, job: JobState, now: float) -> bool:
        return now - job.last_action >= self.cfg.rescale_gap

    # -- Figure 2: a new job is submitted ------------------------------------
    def _admit_decision(self, job: JobState, now: float, verdict: str,
                        free: int, granted: int = 0, alternatives=None):
        if self.decisions is not None:
            spec = job.spec
            self.decisions.record(
                "admit", now, verdict,
                inputs={"job": spec.job_id, "priority": spec.priority,
                        "free": free, "granted": granted,
                        "min": spec.min_replicas, "max": spec.max_replicas},
                alternatives=alternatives)

    def on_new_job(self, cluster: Cluster, job: JobState, now: float,
                   act: Actions) -> None:
        spec = job.spec
        free = self._avail(cluster)
        replicas = spec.feasible(min(free, spec.max_replicas))
        if replicas >= spec.min_replicas:
            # start immediately; never shrink anyone if min fits (paper §3.2.1:
            # "run the higher priority job at its minimum replicas
            #  configuration to avoid a shrink call")
            if act.create(job, replicas):
                self._admit_decision(job, now, "start", free, replicas)
            else:
                act.enqueue(job)    # capacity shrank under us (spot kill)
                self._admit_decision(job, now, "enqueue_raced", free)
            return

        # dry pass: could shrinking strictly-lower/equal-priority running jobs
        # (outside their cool-down) free enough for min_replicas?
        considered = [] if self.decisions is not None else None
        running_desc = self._sorted_desc(cluster.running_jobs(), now)
        num_to_free = spec.min_replicas - free
        p_new = self._priority(job, now)    # `now` is fixed across the loop
        for j in reversed(running_desc):              # lowest priority first
            if num_to_free <= 0:
                break
            if self._priority(j, now) > p_new:
                if considered is not None:
                    considered.append({"job": j.job_id, "eligible": False,
                                       "why": "higher_priority"})
                break                                 # priority guard
            if not self._gap_ok(j, now):
                if considered is not None:
                    considered.append({"job": j.job_id, "eligible": False,
                                       "why": "rescale_gap"})
                continue
            shrinkable = max(0, j.replicas - j.spec.min_replicas)
            if considered is not None:
                considered.append({"job": j.job_id, "eligible": True,
                                   "shrinkable": shrinkable})
            num_to_free -= shrinkable
        if num_to_free > 0:
            act.enqueue(job)
            self._admit_decision(job, now, "enqueue", free,
                                 alternatives=considered)
            return

        # real pass: shrink toward the NEW job's max configuration
        min_to_free = spec.min_replicas - free
        max_to_free = spec.max_replicas - free
        for j in reversed(running_desc):
            if max_to_free <= 0:
                break
            if self._priority(j, now) > p_new:
                break
            if not self._gap_ok(j, now):
                continue
            if j.replicas > j.spec.min_replicas:
                target = j.spec.feasible(
                    max(j.spec.min_replicas, j.replicas - max_to_free))
                if target >= j.replicas or not self._should_shrink(j, target, now):
                    continue
                freed = j.replicas - target
                if act.shrink(j, target):
                    min_to_free -= freed
                    max_to_free -= freed
        if min_to_free > 0:
            act.enqueue(job)    # raced a cool-down; shouldn't normally happen
            self._admit_decision(job, now, "enqueue_raced", free,
                                 alternatives=considered)
            return
        free = self._avail(cluster)
        replicas = spec.feasible(min(free, spec.max_replicas))
        if replicas >= spec.min_replicas and act.create(job, replicas):
            self._admit_decision(job, now, "start_after_shrink", free,
                                 replicas, alternatives=considered)
        else:
            act.enqueue(job)
            self._admit_decision(job, now, "enqueue", free,
                                 alternatives=considered)

    # -- Figure 3: a job completed -------------------------------------------
    def on_job_complete(self, cluster: Cluster, freed_slots: int, now: float,
                        act: Actions) -> None:
        """Redistribute the freed slots (paper: numWorkers = freeWorkers(job))
        over running+queued jobs, highest priority first."""
        num = cluster.free_slots if self.cfg.redistribute_idle else freed_slots
        if num <= 0:
            return    # a yanked node can leave free_slots <= 0: nothing to
            #           offer, so skip building the schedulable list at all
        offered = num
        grants = [] if self.decisions is not None else None
        # offerable_jobs pre-filters the saturation test (running at max)
        # incrementally — the scan order and every decision are identical to
        # walking all_schedulable_jobs, but a loaded fleet's saturated bulk
        # is never touched
        for j in self._sorted_desc(cluster.offerable_jobs(), now):
            if num <= 0:
                break
            # the saturation test is retained verbatim: it still guards
            # free-standing JobStates handed in by tests, and keeps the
            # decision logic readable as Fig. 3's
            r = j.replicas
            spec = j.spec
            if r < spec.max_replicas and self._gap_ok(j, now):
                add = min(num, spec.max_replicas - r)
                new_r = spec.feasible(r + add)
                add = new_r - r
                if add > 0 and new_r >= spec.min_replicas:
                    if (j.status == JobStatus.RUNNING
                            and not self._should_expand(j, new_r, now)):
                        continue
                    started = j.status != JobStatus.RUNNING
                    ok = (act.create(j, new_r) if started
                          else act.expand(j, new_r))
                    if ok:
                        num -= add
                        if grants is not None:
                            grants.append({
                                "job": j.job_id, "to": new_r,
                                "kind": "start" if started else "expand"})
        # any remainder simply stays free
        if grants:
            self.decisions.record(
                "redistribute", now, f"granted_{len(grants)}",
                inputs={"freed": freed_slots, "offered": offered,
                        "leftover": num},
                alternatives=grants)
