"""ElasticClusterController — the Kubernetes-operator analog (paper C2).

Counterpart of ``repro.core.operator``, line for line.  Owns a pool of
devices partitioned into replica slots and runs the *same*
:class:`ElasticPolicy` as the JAX package's simulator, but against live
:class:`ElasticTrainer` jobs: create/shrink/expand build trainers, rebuild
their per-slot step state and move training state (resident on the p2p lane,
through a host snapshot on the host lane).  On one card the "devices" are the
trainers' logical ``Slot``s (``repro_torch.core.elastic.local_slots``), which
each factory receives.  The control loop is cooperative (single-process):
each tick advances every running job by ``steps_per_tick`` train steps — the
scheduling observable is identical to running jobs in parallel processes.

Clocking: the controller's clock advances by each job-step's *modeled* wall
time when ``step_time_fn`` is given (so T_rescale_gap is meaningful in
simulated seconds) or by real wall time otherwise.

Fault tolerance (paper §3.2.2): ``inject_failure`` kills a running job; if a
disk checkpoint exists the job is resubmitted with the restart flag and
resumes from its last snapshot, otherwise it restarts from scratch.

Node awareness: with ``slots_per_node`` the device pool is partitioned into
named nodes (``base00..``) through the same :class:`PlacementMap` the cloud
simulator uses, so the controller kills/drains *specific jobs on specific
nodes* (paper: pods on nodes).  ``inject_node_failure`` abruptly fails every
job resident on a node; ``drain_node`` gracefully migrates residents' workers
onto free slots elsewhere (a live rescale onto the new device set), shrinking
jobs that cannot move and restart-requeueing jobs stuck with nowhere to go.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from repro_torch.checkpoint import DiskCheckpointStore
from repro_torch.core.cluster import Cluster
from repro_torch.core.elastic import ElasticTrainer
from repro_torch.core.job import JobSpec, JobState, JobStatus
from repro_torch.core.metrics import ScheduleMetrics, UtilizationLog, compute_metrics
from repro_torch.core.policies import Actions, ElasticPolicy, PolicyConfig
from repro_torch.obs.decisions import DecisionLog
from repro_torch.obs.stats import Counters, LatencyRecorder
from repro_torch.obs.trace import current_tracer


@dataclass
class LiveJob:
    state: JobState
    factory: Callable[[list], ElasticTrainer]   # devices -> trainer
    trainer: Optional[ElasticTrainer] = None
    checkpoint_every: int = 0                    # steps; 0 = off
    failures: int = 0


class _LiveActions(Actions):
    def __init__(self, op: "ElasticClusterController"):
        self.op = op

    def create(self, job: JobState, replicas: int) -> bool:
        op = self.op
        live = op.live[job.job_id]
        if not op.cluster.can_place(replicas):
            return False        # raced a cordon/drain: stay queued
        slots = op.cluster.place(job.job_id, replicas)
        devices = op.cluster.devices_for_slots(slots)
        resumed = bool(op.restart_flags.get(job.job_id))
        try:
            if live.trainer is None:
                live.trainer = live.factory(devices)
                if op.disk_store is not None and op.restart_flags.get(job.job_id):
                    try:
                        live.trainer.restore_disk(op.disk_store, job.job_id)
                    except FileNotFoundError:
                        pass
            else:   # queued job that had run before (preempted/restarted)
                live.trainer.rescale(devices)
        except Exception:
            op.cluster.release_slots(job.job_id)
            raise
        job.status = JobStatus.RUNNING
        job.replicas = replicas
        job.device_ids = tuple(slots)
        job.last_action = op.now
        if job.start_time is None:
            job.start_time = op.now
        op._record_util()
        op.latency.mark_started(job.job_id, op.now)
        if op.tracer.enabled:
            op.tracer.emit("job_start", t=op.now, job=job.job_id,
                           slots=replicas, priority=job.spec.priority,
                           resume=resumed, overhead_s=0.0)
        return True

    def expand(self, job: JobState, replicas: int) -> bool:
        return self._rescale(job, replicas)

    def shrink(self, job: JobState, replicas: int) -> bool:
        return self._rescale(job, replicas)

    def _rescale(self, job: JobState, replicas: int) -> bool:
        op = self.op
        live = op.live[job.job_id]
        if replicas == job.replicas or live.trainer is None:
            return True
        if replicas > job.replicas:
            extra = replicas - job.replicas
            if extra > op.cluster.free_slots:
                return False
            op.cluster.place(job.job_id, extra)
        else:
            # a drain names its node via _evict_prefer; cordoned nodes are
            # vacated first regardless
            op.cluster.evict(job.job_id, job.replicas - replicas,
                             prefer=op._evict_prefer)
        slots = op.cluster.slots_of(job.job_id)
        devices = op.cluster.devices_for_slots(slots)
        from_replicas = job.replicas
        timings = live.trainer.rescale(devices)
        op.rescale_events.append((op.now, job.job_id, job.replicas, replicas,
                                  timings))
        op.advance_clock(timings.total)
        job.replicas = replicas
        job.device_ids = tuple(slots)
        job.last_action = op.now
        job.rescale_count += 1
        op._record_util()
        op.counters.inc("rescales")
        if op.tracer.enabled:
            op.tracer.emit("job_rescale", t=op.now, job=job.job_id,
                           **{"from": from_replicas, "to": replicas},
                           overhead_s=timings.total)
        return True

    def enqueue(self, job: JobState) -> None:
        job.status = JobStatus.QUEUED
        op = self.op
        op.latency.mark_queued(job.job_id, op.now)
        if op.tracer.enabled:
            op.tracer.emit("job_queue", t=op.now, job=job.job_id)


class ElasticClusterController:
    def __init__(self, devices: list, *, slots: int, devices_per_slot: int = 1,
                 policy: PolicyConfig = PolicyConfig(rescale_gap=0.0),
                 disk_store: Optional[DiskCheckpointStore] = None,
                 step_time_fn: Optional[Callable[[JobState], float]] = None,
                 steps_per_tick: int = 1,
                 slots_per_node: Optional[int] = None,
                 placement: str = "pack", tracer=None):
        self.cluster = Cluster(slots, devices, devices_per_slot,
                               slots_per_node=slots_per_node,
                               placement=placement)
        self.policy = ElasticPolicy(policy)
        self.actions = _LiveActions(self)
        self.live: Dict[str, LiveJob] = {}
        self.pending: List[JobState] = []
        self.disk_store = disk_store
        self.restart_flags: Dict[str, bool] = {}
        self.step_time_fn = step_time_fn
        self.steps_per_tick = steps_per_tick
        self.now = 0.0
        self._wall0 = time.perf_counter()
        self._evict_prefer: Optional[str] = None  # forced-shrink target node
        self.util = UtilizationLog(slots)
        self.rescale_events: List[tuple] = []
        self.replica_trace: List[tuple] = []     # (t, job_id, replicas)
        # observability: same flight recorder as the simulators, so one
        # auditor/timeline consumes traces from both lanes
        self.tracer = tracer if tracer is not None else current_tracer()
        self.counters = Counters()
        self.latency = LatencyRecorder()
        self.run_id = self.tracer.next_run_id()
        self._submitted: set = set()     # job_submit emitted (resubmits skip)
        if self.tracer.enabled:
            self.tracer.emit("run_start", t=0.0, run=self.run_id, slots=slots,
                             sim=type(self).__name__)

    # -- clock ----------------------------------------------------------------
    def advance_clock(self, dt: float):
        if self.step_time_fn is not None:
            self.now += dt
        else:
            self.now = time.perf_counter() - self._wall0

    def _record_util(self):
        self.util.record(self.now, self.cluster.used_slots)
        if self.cluster.node_count > 1:     # single-node: frag is undefined
            self.util.record_fragmentation(self.now,
                                           self.cluster.fragmentation())
        for j in self.cluster.jobs.values():
            self.replica_trace.append((self.now, j.job_id, j.replicas))

    # -- API --------------------------------------------------------------------
    def submit(self, spec: JobSpec, factory: Callable[[list], ElasticTrainer],
               checkpoint_every: int = 0, restart: bool = False):
        state = JobState(spec=spec)
        self.live[spec.job_id] = LiveJob(state=state, factory=factory,
                                         checkpoint_every=checkpoint_every)
        self.restart_flags[spec.job_id] = restart
        self.pending.append(state)
        self.pending.sort(key=lambda j: j.spec.submit_time)

    def inject_failure(self, job_id: str):
        """Kill a running job (process failure).  Resubmission goes through
        the normal newJob path with the restart flag set (paper §3.2.2)."""
        self._fail_and_resubmit(job_id)

    def _fail_and_resubmit(self, job_id: str, redistribute: bool = True):
        """``redistribute=False`` defers the Fig.-3 pass so multi-victim
        callers (node failure) don't expand a job they are about to kill."""
        job = self.cluster.jobs[job_id]
        live = self.live[job_id]
        assert job.status == JobStatus.RUNNING
        self.cluster.evict(job_id)
        freed = job.replicas
        job.replicas = 0
        job.status = JobStatus.PENDING
        live.trainer = None          # process state lost
        live.failures += 1
        self.restart_flags[job_id] = True
        del self.cluster.jobs[job_id]
        self._record_util()
        self.counters.inc("failures")
        self.latency.mark_queued(job_id, self.now)
        if self.tracer.enabled:
            self.tracer.emit("job_fail", t=self.now, job=job_id, slots=freed)
        if redistribute:
            # freed capacity is redistributed like a completion
            self.policy.on_job_complete(self.cluster, freed, self.now,
                                        self.actions)
        # resubmit immediately
        self.pending.append(job)
        self.pending.sort(key=lambda j: j.spec.submit_time)

    # -- node-level operations (paper: pods on nodes) -------------------------
    def inject_node_failure(self, node_id: str) -> List[str]:
        """Abrupt node death: every job resident on the node loses workers
        with no warning — per-worker state is unrecoverable, so each victim
        restarts from its last disk checkpoint (or scratch), exactly like
        :meth:`inject_failure` but with a placement-exact blast set.  The
        node's capacity stays offline until :meth:`recover_node`."""
        victims = sorted(self.cluster.residents(node_id))
        if self.tracer.enabled:
            self.tracer.emit("node_cordon", t=self.now, node=node_id,
                             cause="failure")
        self.cluster.cordon(node_id)
        self.util.record_capacity(self.now, self.cluster.total_slots)
        for job_id in victims:
            # defer redistribution: a mid-loop Fig.-3 pass could expand (a
            # real trainer rescale) a job this loop kills next
            self._fail_and_resubmit(job_id, redistribute=False)
        free = self.cluster.free_slots
        if victims and free > 0:
            self.policy.on_job_complete(self.cluster, free, self.now,
                                        self.actions)
        return victims

    def recover_node(self, node_id: str) -> None:
        """A failed/drained node rejoins; its capacity is offered to queued
        and running jobs like a completion (Fig. 3 pass)."""
        self.cluster.uncordon(node_id)
        self.util.record_capacity(self.now, self.cluster.total_slots)
        if self.tracer.enabled:
            self.tracer.emit("node_uncordon", t=self.now, node=node_id)
        free = self.cluster.free_slots
        if free > 0:
            self.policy.on_job_complete(self.cluster, free, self.now,
                                        self.actions)

    def drain_node(self, node_id: str) -> None:
        """Graceful drain (`kubectl drain` analog): cordon the node, then for
        each resident job — highest priority first — migrate its workers onto
        free slots elsewhere (live rescale onto the new device set), shrink
        what cannot move, and restart-requeue jobs stuck with nowhere to go.
        The node ends cordoned and empty."""
        if self.tracer.enabled:
            self.tracer.emit("node_cordon", t=self.now, node=node_id,
                             cause="drain")
        self.cluster.cordon(node_id)
        self.util.record_capacity(self.now, self.cluster.total_slots)
        residents = self.cluster.residents(node_id)
        requeued = 0
        for job_id in sorted(residents,
                             key=lambda i: self.cluster.jobs[i].sort_key()):
            job = self.cluster.jobs[job_id]
            live = self.live[job_id]
            moved = self.cluster.migrate(job_id, node_id)
            if moved and live.trainer is not None:
                slots = self.cluster.slots_of(job_id)
                devices = self.cluster.devices_for_slots(slots)
                timings = live.trainer.rescale(devices)
                self.rescale_events.append(
                    (self.now, job_id, job.replicas, job.replicas, timings))
                self.advance_clock(timings.total)
                job.device_ids = tuple(slots)
                self.counters.inc("migrations")
                if self.tracer.enabled:
                    self.tracer.emit("job_migrate", t=self.now, job=job_id,
                                     from_node=node_id, moved=moved,
                                     overhead_s=timings.total)
            still = self.cluster.residents(node_id).get(job_id, 0)
            if still:
                target = job.spec.feasible(
                    max(job.spec.min_replicas, job.replicas - still))
                # only shrink when it clears the node: a partial shrink is a
                # live rescale thrown away by the requeue below
                if target < job.replicas and target <= job.replicas - still:
                    self._evict_prefer = node_id
                    try:
                        self.actions.shrink(job, target)
                    finally:
                        self._evict_prefer = None
            if self.cluster.residents(node_id).get(job_id, 0):
                # nowhere to go: requeue — deferring redistribution so the
                # freed slots aren't handed out before later residents get
                # their chance to migrate onto them
                self._fail_and_resubmit(job_id, redistribute=False)
                requeued += 1
        assert not self.cluster.residents(node_id)
        free = self.cluster.free_slots
        if requeued and free > 0:
            self.policy.on_job_complete(self.cluster, free, self.now,
                                        self.actions)
        self._record_util()

    # -- control loop -------------------------------------------------------------
    def _process_submissions(self):
        while self.pending and self.pending[0].spec.submit_time <= self.now:
            job = self.pending.pop(0)
            if job.job_id not in self.cluster.jobs:
                self.cluster.add_job(job)
            if job.job_id not in self._submitted:
                # failed jobs resubmit through this same path: one submit
                # record per job, so trace lifecycle counts reconcile
                self._submitted.add(job.job_id)
                if self.tracer.enabled:
                    self.tracer.emit("job_submit", t=self.now,
                                     job=job.job_id,
                                     priority=job.spec.priority,
                                     min=job.spec.min_replicas,
                                     max=job.spec.max_replicas)
            self.policy.on_new_job(self.cluster, job, self.now, self.actions)

    def _complete(self, job: JobState):
        freed = job.replicas
        self.cluster.release_slots(job.job_id)
        job.status = JobStatus.COMPLETED
        job.end_time = self.now
        job.replicas = 0
        self._record_util()
        self.counters.inc("completions")
        self.latency.observe_completed(job)
        if self.tracer.enabled:
            self.tracer.emit("job_complete", t=self.now, job=job.job_id,
                             slots=freed)
        self.policy.on_job_complete(self.cluster, freed, self.now, self.actions)

    def run(self, max_ticks: int = 1_000_000) -> ScheduleMetrics:
        if self.tracer.enabled and \
                getattr(self.policy, "decisions", None) is None:
            self.policy.decisions = DecisionLog(self.tracer)
        ticks = 0
        while ticks < max_ticks:
            ticks += 1
            self.counters.inc("ticks")
            self._process_submissions()
            running = [j for j in self.cluster.jobs.values()
                       if j.status == JobStatus.RUNNING]
            if not running:
                if self.pending:
                    # idle-advance to the next submission
                    self.advance_clock(
                        max(0.0, self.pending[0].spec.submit_time - self.now)
                        if self.step_time_fn else 0.0)
                    if self.step_time_fn is None:
                        self.now = max(self.now,
                                       self.pending[0].spec.submit_time)
                    continue
                break
            for job in running:
                live = self.live[job.job_id]
                for _ in range(self.steps_per_tick):
                    if live.trainer.done:
                        break
                    live.trainer.step()
                    dt = (self.step_time_fn(job) if self.step_time_fn
                          else 0.0)
                    self.advance_clock(dt)
                    ce = live.checkpoint_every
                    if (self.disk_store is not None and ce
                            and live.trainer.step_idx % ce == 0):
                        live.trainer.save_disk(self.disk_store, job.job_id)
                if live.trainer.done and job.status == JobStatus.RUNNING:
                    self._complete(job)
        metrics = compute_metrics(list(self.cluster.jobs.values()), self.util,
                                  latency=self.latency,
                                  counters=self.counters.as_dict())
        if self.tracer.enabled:
            # failed-and-never-restarted jobs live in self.pending, outside
            # cluster.jobs — reconcile drops against emitted submit records
            completes = self.counters.get("completions")
            self.tracer.emit("run_end", t=self.now, run=self.run_id,
                             total_cost=metrics.total_cost,
                             transfer_cost=metrics.transfer_cost,
                             preempt_overhead_cost=metrics.preempt_overhead_cost,
                             dropped=max(0, len(self._submitted) - completes),
                             rescales=metrics.rescale_count)
            self.tracer.flush()
        return metrics
