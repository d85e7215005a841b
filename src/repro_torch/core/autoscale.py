"""Beyond-paper scheduling extensions.

Copy of ``repro.core.autoscale`` (framework-free).

The paper explicitly defers these (§3.2.2 Discussion, §6 Future work); we
implement them as policy subclasses so every variant runs in both the
simulator and the live operator:

- :class:`AgingPolicy` — "a dynamic priority system could be implemented to
  gradually increase the priority of waiting jobs" (§3.2.2).  Effective
  priority = priority + age_rate * queue_wait.  Bounds starvation of
  low-priority jobs under heavy traffic (property-tested).
- :class:`CostBenefitPolicy` — "we do not consider the cost versus the
  potential benefit of rescaling" (§6).  Expansion is granted only if the
  modeled runtime saving over the job's remaining work exceeds
  ``benefit_margin`` x the modeled rescale overhead; shrinking a job with less
  than ``protect_tail`` of its work remaining is declined (the application-
  declines-rescale protocol of §6, folded into the scheduler using the same
  perf models the simulator trusts).
- :class:`PreemptingPolicy` — "lower-priority jobs could be sent a signal to
  checkpoint to disk and then be preempted" (§3.2.2).  When shrinking
  everything to min still cannot start a higher-priority job, the lowest-
  priority running jobs are checkpointed and requeued (they resume later with
  their progress intact); requires an :class:`Actions` implementation with
  ``preempt``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core.cluster import Cluster
from repro_torch.core.job import JobState, JobStatus
from repro_torch.core.policies import Actions, ElasticPolicy, PolicyConfig


class AgingPolicy(ElasticPolicy):
    def __init__(self, cfg: PolicyConfig, *, age_rate: float = 1.0 / 600.0,
                 max_boost: float = 4.0):
        super().__init__(cfg)
        self.age_rate = age_rate
        self.max_boost = max_boost

    def _priority(self, job: JobState, now: float) -> float:
        base = float(job.spec.priority)
        if job.status in (JobStatus.QUEUED, JobStatus.PENDING):
            wait = max(0.0, now - job.spec.submit_time)
            return base + min(self.max_boost, self.age_rate * wait)
        return base


class CostBenefitPolicy(ElasticPolicy):
    """workload_fn(job) must return an object with .scaling.time_per_step,
    .data_bytes, .rescale (the simulator's SimWorkload fits directly)."""

    def __init__(self, cfg: PolicyConfig, workload_fn: Callable,
                 *, benefit_margin: float = 1.0, protect_tail: float = 0.05):
        super().__init__(cfg)
        self.workload_fn = workload_fn
        self.benefit_margin = benefit_margin
        self.protect_tail = protect_tail

    def _should_expand(self, job: JobState, new_replicas: int, now: float
                       ) -> bool:
        if self.sync_job is not None:   # lazy sync: bring work_remaining to
            self.sync_job(job)          # `now` only where it is actually read
        wl = self.workload_fn(job)
        t_old = wl.scaling.time_per_step(job.replicas)
        t_new = wl.scaling.time_per_step(new_replicas)
        benefit = job.work_remaining * max(0.0, t_old - t_new)
        cost = wl.rescale.total(job.replicas, new_replicas, wl.data_bytes)
        return benefit > self.benefit_margin * cost

    def _should_shrink(self, job: JobState, new_replicas: int, now: float
                       ) -> bool:
        if self.sync_job is not None:
            self.sync_job(job)
        wl = self.workload_fn(job)
        if wl.total_work > 0 and \
                job.work_remaining / wl.total_work < self.protect_tail:
            return False    # nearly done: let it finish (§6)
        return True


class PreemptingPolicy(ElasticPolicy):
    """Adds disk-checkpoint preemption as the last resort of Fig. 2."""

    def on_new_job(self, cluster: Cluster, job: JobState, now: float,
                   act: Actions) -> None:
        super().on_new_job(cluster, job, now, act)
        if job.status != JobStatus.QUEUED:
            return
        if not hasattr(act, "preempt"):
            return
        # preempt strictly-lower-priority running jobs, lowest first, until
        # the new job can start at min_replicas
        needed = job.spec.min_replicas - self._avail(cluster)
        if needed <= 0:
            return
        considered = [] if self.decisions is not None else None
        victims = []
        for j in reversed(self._sorted_desc(cluster.running_jobs(), now)):
            if self._priority(j, now) >= self._priority(job, now):
                if considered is not None:
                    considered.append({"job": j.job_id, "eligible": False,
                                       "why": "priority_ceiling"})
                break
            victims.append(j)
            if considered is not None:
                considered.append({"job": j.job_id, "eligible": True,
                                   "slots": j.replicas,
                                   "priority": j.spec.priority})
            needed -= j.replicas
            if needed <= 0:
                break
        if needed > 0:
            if self.decisions is not None:
                self.decisions.record(
                    "preempt_select", now, "insufficient",
                    inputs={"job": job.spec.job_id, "short": needed},
                    alternatives=considered)
            return      # even preempting everything lower wouldn't fit
        for v in victims:
            act.preempt(v)
        free = self._avail(cluster)
        replicas = job.spec.feasible(min(free, job.spec.max_replicas))
        started = False
        if replicas >= job.spec.min_replicas:
            started = act.create(job, replicas)
            # on failure the job simply stays QUEUED for redistribution
        if self.decisions is not None:
            self.decisions.record(
                "preempt_select", now,
                "preempted_started" if started else "preempted_queued",
                inputs={"job": job.spec.job_id,
                        "victims": [v.job_id for v in victims],
                        "granted": replicas if started else 0},
                alternatives=considered)
