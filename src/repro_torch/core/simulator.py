"""Discrete-event scheduler simulator — paper contribution C3.

Copy of ``repro.core.simulator`` (framework-free): the same event loop,
policy calls and float arithmetic in the same order, so both packages give
bit-equal ``ScheduleMetrics`` and trace records on the same inputs.

Reproduces §4.3.1: Fig. 7 (submission-gap sweep), Fig. 8 (T_rescale_gap
sweep), and the simulation columns of Table 1.  Job runtime vs. replicas and
rescale overheads come from the piecewise models in ``perf_model`` (the paper
interpolates measured Jacobi2D points; we synthesize them from an analytic
model calibrated to the paper's magnitudes).

Progress accounting: a running job accrues work at ``1/time_per_step(r)``
steps/s except inside its rescale-overhead window.  Completion events carry a
version stamp so a rescale invalidates the stale completion.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import lru_cache
from time import perf_counter
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.cluster import Cluster
from repro_torch.core.events import _CANCELLED, EventQueue
from repro_torch.core.job import JobSpec, JobState, JobStatus
from repro_torch.core.metrics import ScheduleMetrics, UtilizationLog, compute_metrics
from repro_torch.core.perf_model import (JACOBI_SIZES, JacobiModel,
                                   PiecewiseScalingModel, RescaleModel)
from repro_torch.core.policies import ElasticPolicy, PolicyConfig
from repro_torch.obs.critical_path import NullPhaseLedger, PhaseLedger
from repro_torch.obs.decisions import DecisionLog
from repro_torch.obs.profile import current_profiler
from repro_torch.obs.stats import Counters, LatencyRecorder
from repro_torch.obs.trace import current_tracer


@dataclass
class SimWorkload:
    """Perf description of one simulated job."""
    scaling: object                 # .time_per_step(replicas) -> s
    total_work: float               # steps
    data_bytes: float
    rescale: RescaleModel = field(default_factory=RescaleModel)


class _SimActions:
    """Actions implementation mutating simulator state (virtual clock)."""

    def __init__(self, sim: "Simulator"):
        self.sim = sim

    # paper: rigid emulation also passes through here; policy never calls
    # shrink/expand on rigid jobs because min == max.
    def create(self, job: JobState, replicas: int) -> bool:
        sim = self.sim
        # capacity can shrink under a running policy (spot kill between the
        # policy's free_slots read and this call) — refuse, don't crash.
        # free_slots <= placement free always (jobs resident on cordoned
        # nodes count as used), so this one check also guarantees place()
        if replicas <= 0 or replicas > sim.cluster.free_slots:
            return False
        job_id = job.spec.job_id
        sim.cluster.place(job_id, replicas)
        job.status = JobStatus.RUNNING
        job.replicas = replicas
        job.last_action = sim.now
        if job.start_time is None:
            job.start_time = sim.now
        sim.last_resume_s = 0.0
        resumed = False
        if job.preempt_count and job.work_remaining < sim.workloads[
                job_id].total_work:
            # resuming a preempted job: restart + restore-from-disk; the
            # cost is published (like last_preempt_ckpt_s) so extensions
            # bill exactly what the simulation charged the clock
            wl = sim.workloads[job_id]
            sim.last_resume_s = wl.rescale.resume_cost(replicas,
                                                       wl.data_bytes)
            job.overhead_until = sim.now + sim.last_resume_s
            resumed = True
        job.last_progress_time = sim.now
        sim._schedule_completion(job)
        sim._record_util()
        sim.latency.mark_started(job_id, sim.now)
        sim.phases.on_start(job_id, sim.now, restore_s=sim.last_resume_s)
        if sim.tracer.enabled:
            sim.tracer.emit("job_start", t=sim.now, job=job_id,
                            slots=replicas, priority=job.spec.priority,
                            resume=resumed, overhead_s=sim.last_resume_s)
        return True

    def expand(self, job: JobState, replicas: int) -> bool:
        return self._rescale(job, replicas)

    def shrink(self, job: JobState, replicas: int) -> bool:
        return self._rescale(job, replicas)

    def _rescale(self, job: JobState, replicas: int) -> bool:
        sim = self.sim
        if replicas == job.replicas:
            return True
        from_replicas = job.replicas
        delta = replicas - from_replicas
        # shrinks always succeed — even when free_slots is negative because a
        # node was yanked (the cloud layer shrinks victims to resolve exactly
        # that deficit)
        if delta > 0 and delta > sim.cluster.free_slots:
            return False
        job_id = job.spec.job_id
        if delta > 0:
            sim.cluster.place(job_id, delta)
        else:
            # a forced shrink (spot kill) names the dying node via
            # _evict_prefer so the freed slots come off it exactly — even
            # when another node is cordoned for an in-flight drain; absent
            # that, cordoned nodes are vacated first anyway
            sim.cluster.evict(job_id, -delta, prefer=sim._evict_prefer)
        sim._sync_progress(job)
        wl = sim.workloads[job_id]
        overhead = wl.rescale.total(job.replicas, replicas, wl.data_bytes)
        job.overhead_until = max(sim.now, job.overhead_until) + overhead
        job.replicas = replicas
        job.last_action = sim.now
        job.rescale_count += 1
        sim.total_overhead += overhead
        sim._schedule_completion(job)
        sim._record_util()
        sim.counters.inc("rescales")
        sim.phases.on_rescale(job_id, sim.now, overhead)
        if sim.tracer.enabled:
            sim.tracer.emit("job_rescale", t=sim.now, job=job_id,
                            **{"from": from_replicas, "to": replicas},
                            overhead_s=overhead)
        return True

    def enqueue(self, job: JobState) -> None:
        job.status = JobStatus.QUEUED
        sim = self.sim
        sim.latency.mark_queued(job.job_id, sim.now)
        if sim.tracer.enabled:
            sim.tracer.emit("job_queue", t=sim.now, job=job.job_id)

    def preempt(self, job: JobState) -> bool:
        """Checkpoint-to-disk preemption (core/autoscale.PreemptingPolicy)."""
        sim = self.sim
        sim._sync_progress(job)
        wl = sim.workloads[job.job_id]
        # the victim pays the disk checkpoint before its slots free up; the
        # cost is published so extensions (cloud overhead billing) price
        # exactly the checkpoint the simulation charged, never a re-derival
        sim.last_preempt_ckpt_s = wl.rescale.preempt_cost(job.replicas,
                                                          wl.data_bytes)
        sim.now += sim.last_preempt_ckpt_s
        sim.counters.inc("preemptions")
        sim.latency.mark_queued(job.job_id, sim.now)
        sim.phases.on_preempt(job.job_id, sim.now, sim.last_preempt_ckpt_s)
        if sim.tracer.enabled:
            sim.tracer.emit("job_preempt", t=sim.now, job=job.job_id,
                            slots=job.replicas,
                            ckpt_s=sim.last_preempt_ckpt_s)
        sim.cluster.evict(job.job_id)
        job.status = JobStatus.QUEUED
        job.replicas = 0
        job.version += 1            # invalidate its completion event
        sim._cancel_completion(job)
        job.preempt_count += 1
        # queued jobs must always pass the rescale-gap check (job.py: Fig. 3
        # hands slots to queued jobs regardless of recency) — anchoring
        # last_action here would strand the victim for a whole gap window
        job.last_action = -math.inf
        sim._record_util()
        return True


class Simulator:
    def __init__(self, total_slots: int, policy_cfg: PolicyConfig, *,
                 placement: str = "pack",
                 slots_per_node: Optional[int] = None, tracer=None,
                 profiler=None, util_series: bool = True,
                 track_phases: bool = True):
        """``util_series=False`` / ``track_phases=False`` put the simulator
        in bounded-memory fleet mode (the JAX package's ~1M-job fleet
        replay): utilization integrals run on O(1) accumulators instead of a
        retained step series, and per-job phase decomposition is skipped."""
        self.cluster = Cluster(total_slots, slots_per_node=slots_per_node,
                               placement=placement)
        self.policy = ElasticPolicy(policy_cfg)
        self.queue = EventQueue()
        self.actions = _SimActions(self)
        self.workloads: Dict[str, SimWorkload] = {}
        self.util = UtilizationLog(total_slots, keep_series=util_series)
        # job_id -> queued completion Event, so a rescale CANCELS the stale
        # completion in place (tombstone, dropped inside the heap) instead of
        # paying a full dispatch when it eventually surfaces
        self._pending_complete: Dict[str, object] = {}
        self.now = 0.0
        self.total_overhead = 0.0
        self.last_preempt_ckpt_s = 0.0  # ckpt seconds of the latest preempt
        self.last_resume_s = 0.0        # restore seconds of the latest create
        self._evict_prefer: Optional[str] = None   # forced-shrink target node
        # observability (repro_torch.obs): explicit tracer wins, else whatever
        # `obs.trace.install` put up, else the no-op null tracer
        self.tracer = tracer if tracer is not None else current_tracer()
        # self-profiler (repro_torch.obs.profile): same precedence; None = off
        self.profiler = profiler if profiler is not None \
            else current_profiler()
        self.queue.profiler = self.profiler
        self.counters = Counters()
        self.latency = LatencyRecorder()
        # makespan decomposition (repro_torch.obs.critical_path); a no-op ledger in
        # bounded-memory fleet mode
        self.phases = PhaseLedger() if track_phases else NullPhaseLedger()
        self.run_id = self.tracer.next_run_id()
        if self.tracer.enabled:
            # emitted from __init__ so subclass capacity bootstrap (cloud
            # node_up records) lands inside the run span
            self.tracer.emit("run_start", t=0.0, run=self.run_id,
                             slots=total_slots, sim=type(self).__name__)

    # -- bookkeeping ---------------------------------------------------------
    def _record_util(self):
        prof = self.profiler
        t0 = perf_counter() if prof is not None else 0.0
        self.util.record(self.now, self.cluster.used_slots)
        if self.cluster.node_count > 1:     # single-node: frag is undefined
            self.util.record_fragmentation(self.now,
                                           self.cluster.fragmentation())
        if prof is not None:
            prof.section("metrics_tick", perf_counter() - t0)

    def _rate(self, job: JobState) -> float:
        wl = self.workloads[job.job_id]
        return 1.0 / wl.scaling.time_per_step(job.replicas)

    def _sync_progress(self, job: JobState):
        if job.status != JobStatus.RUNNING:
            return
        start = max(job.last_progress_time, min(job.overhead_until, self.now))
        if self.now > start:
            job.work_remaining -= (self.now - start) * self._rate(job)
        job.last_progress_time = self.now

    def _cancel_completion(self, job: JobState) -> None:
        prev = self._pending_complete.pop(job.job_id, None)
        if prev is not None:
            self.queue.cancel(prev)

    def _schedule_completion(self, job: JobState):
        job.version += 1
        job_id = job.spec.job_id
        prev = self._pending_complete.pop(job_id, None)
        if prev is not None:            # the old event is now a tombstone
            self.queue.cancel(prev)
        begin = max(self.now, job.overhead_until)
        t_done = begin + job.work_remaining * \
            self.workloads[job_id].scaling.time_per_step(job.replicas)
        self._pending_complete[job_id] = self.queue.push(
            t_done, "complete", (job_id, job.version))

    # -- API -----------------------------------------------------------------
    def submit(self, spec: JobSpec, workload: SimWorkload):
        """Register an arrival at ``spec.submit_time``.  Arrival processing
        order depends only on (submit_time, -priority, job_id) — never on the
        order submit() was called in — so replaying a bursty trace (many
        arrivals collapsed onto one timestamp) is insertion-agnostic."""
        state = JobState(spec=spec, work_remaining=workload.total_work)
        self.workloads[spec.job_id] = workload
        self.queue.push(spec.submit_time, "submit", state,
                        tiebreak=(-spec.priority, spec.job_id))

    def run(self) -> ScheduleMetrics:
        if self.tracer.enabled:
            self._wire_decisions()
        # lazy progress sync: extension hooks that read work_remaining
        # (CostBenefitPolicy) pull the job up to date themselves instead of
        # the loop syncing every running job on every submit/complete
        self.policy.sync_job = self._sync_progress
        counters = self.counters
        prof = self.profiler
        batch: List = []
        stop = False
        n_events = 0    # folded into counters once, after the loop
        # one heap pass drains ALL events sharing the earliest timestamp
        # (tombstoned stale completions are dropped inside the pass); events
        # within the batch dispatch in exactly the old pop-by-pop order
        while not stop:
            if prof is None:
                if not self.queue.pop_batch(batch):
                    break
            else:
                t0 = perf_counter()
                n = self.queue.pop_batch(batch)
                prof.section("heap_pop", perf_counter() - t0)
                if not n:
                    break
            for ev in batch:
                if self._should_stop():
                    stop = True
                    break
                # an earlier event in THIS batch may have cancelled this one
                # (a same-timestamp admission shrinking a running job kills
                # its completion event); the per-event pop() used to drop it
                # at pop time, so the batch loop must re-check
                if ev.kind is _CANCELLED:
                    self.queue._popped(ev)
                    continue
                if prof is None:
                    self.now = max(self.now, ev.time)
                    n_events += 1
                    self._dispatch(ev)
                else:
                    t1 = perf_counter()
                    self.now = max(self.now, ev.time)
                    n_events += 1
                    self._dispatch(ev)
                    prof.event(ev.kind, perf_counter() - t1)
        counters.inc("events", n_events)
        counters.inc("stale_events", self.queue.stale_total)
        metrics = self._final_metrics()
        if self.tracer.enabled:
            self.tracer.emit(
                "run_end", t=self.now, run=self.run_id,
                total_cost=metrics.total_cost,
                transfer_cost=metrics.transfer_cost,
                preempt_overhead_cost=metrics.preempt_overhead_cost,
                dropped=metrics.dropped_jobs,
                rescales=metrics.rescale_count)
            self.tracer.flush()
        return metrics

    def _dispatch(self, ev) -> None:
        """Process one popped event (clock already advanced, counter
        ticked).  Split out of :meth:`run` so the profiler can time every
        event by kind with two ``perf_counter`` calls around one method."""
        if ev.kind == "submit":
            job: JobState = ev.payload
            self.cluster.add_job(job)
            self.phases.on_submit(job.job_id, self.now,
                                  priority=job.spec.priority)
            if self.tracer.enabled:
                self.tracer.emit("job_submit", t=self.now,
                                 job=job.job_id,
                                 priority=job.spec.priority,
                                 min=job.spec.min_replicas,
                                 max=job.spec.max_replicas)
            # policies that consult work_remaining (cost-benefit) sync the
            # job themselves via the sync_job hook — no sync-all pass here
            self.policy.on_new_job(self.cluster, job, self.now,
                                   self.actions)
        elif ev.kind == "complete":
            job_id, version = ev.payload
            if self._pending_complete.get(job_id) is ev:
                del self._pending_complete[job_id]
            job = self.cluster.jobs[job_id]
            if job.version != version or job.status != JobStatus.RUNNING:
                return         # stale event (job was rescaled since)
            self._sync_progress(job)
            if job.work_remaining > 1e-6:   # overhead pushed completion
                self._schedule_completion(job)
                return
            freed = job.replicas
            self.cluster.evict(job_id)
            job.status = JobStatus.COMPLETED
            job.end_time = self.now
            job.replicas = 0
            self._record_util()
            self.counters.inc("completions")
            self.latency.observe_completed(job)
            self.phases.on_complete(job_id, self.now)
            if self.tracer.enabled:
                self.tracer.emit("job_complete", t=self.now,
                                 job=job.job_id, slots=freed)
            self.policy.on_job_complete(self.cluster, freed, self.now,
                                        self.actions)
        else:
            # extension point: repro_torch.cloud adds node_up / node_down /
            # spot_kill / autoscale_tick event kinds
            self._handle_event(ev)

    def _final_metrics(self) -> ScheduleMetrics:
        """Extension hook: CloudSimulator closes its cost ledger here so the
        base run loop can emit one ``run_end`` record with final dollars."""
        return compute_metrics(list(self.cluster.jobs.values()), self.util,
                               latency=self.latency,
                               counters=self.counters.as_dict(),
                               phases=self.phases)

    def _wire_decisions(self) -> None:
        """Bind a DecisionLog to every decision-carrying component (policies
        are often swapped after __init__, so this runs at the top of run())."""
        log = DecisionLog(self.tracer)
        if getattr(self.policy, "decisions", None) is None:
            self.policy.decisions = log

    def _handle_event(self, ev) -> None:
        raise ValueError(f"unknown event kind {ev.kind!r}")

    def _should_stop(self) -> bool:
        """Extension hook: lets subclasses end the run before the queue
        drains (cloud sims carry perpetual node-lifecycle events that would
        otherwise bill idle nodes out to their far-future spot fates)."""
        return False


# ---------------------------------------------------------------------------
# Workload generation (paper §4.3.1)
# ---------------------------------------------------------------------------

REPLICA_GRID = (1, 2, 4, 8, 16, 32, 64, 128)


def jacobi_workload(size: str) -> SimWorkload:
    d = JACOBI_SIZES[size]
    model = JacobiModel(d["grid_n"], d["timesteps"])
    return SimWorkload(
        scaling=model.scaling_model(REPLICA_GRID),
        total_work=float(d["timesteps"]),
        data_bytes=model.data_bytes,
    )


@lru_cache(maxsize=None)
def _jacobi_workload_cached(size: str) -> SimWorkload:
    """One shared SimWorkload per size for the default run_variant path:
    the simulator only ever reads workloads (scaling/total_work/data_bytes/
    rescale are immutable), and synthesizing the scaling points is ~10x the
    cost of a simulated event."""
    return jacobi_workload(size)


def make_jacobi_jobs(seed: int, n_jobs: int = 16, submission_gap: float = 90.0,
                     sizes: Optional[Sequence[str]] = None) -> List[JobSpec]:
    """16 jobs drawn from the 4 sizes with priorities U{1..5} (paper).
    ``sizes`` restricts the mix (e.g. ("small", "medium") for the cloud-cost
    benchmark, where jobs must not absorb arbitrary capacity)."""
    rng = np.random.default_rng(seed)
    sizes = list(sizes) if sizes is not None else list(JACOBI_SIZES)
    specs = []
    for i in range(n_jobs):
        size = sizes[int(rng.integers(len(sizes)))]
        d = JACOBI_SIZES[size]
        specs.append(JobSpec(
            job_id=f"job{i:03d}-{size}",
            priority=int(rng.integers(1, 6)),
            min_replicas=d["min_replicas"],
            max_replicas=d["max_replicas"],
            submit_time=i * submission_gap,
            workload=size,
        ))
    return specs


def variant_setup(variant: str, specs: Sequence[JobSpec], *,
                  rescale_gap: float = 180.0, launcher_reserve: int = 0):
    """Specs transform + policy for one scheduler variant (paper §4.3's four
    schedulers plus the preempting extension).  Returns ``(specs, pcfg,
    policy)`` where ``policy`` is None for the plain config-driven
    ElasticPolicy.  Shared by :func:`run_variant` and the trace-replay layer
    (``repro_torch.workloads.replay``) so the variant semantics cannot
    drift."""
    policy = None
    if variant == "rigid_min":
        specs = [s.rigid(s.min_replicas) for s in specs]
        pcfg = PolicyConfig(rescale_gap=rescale_gap,
                            launcher_reserve=launcher_reserve)
    elif variant == "rigid_max":
        specs = [s.rigid(s.max_replicas) for s in specs]
        pcfg = PolicyConfig(rescale_gap=rescale_gap,
                            launcher_reserve=launcher_reserve)
    elif variant == "moldable":
        pcfg = PolicyConfig.moldable(launcher_reserve=launcher_reserve)
    elif variant == "elastic":
        pcfg = PolicyConfig(rescale_gap=rescale_gap,
                            launcher_reserve=launcher_reserve)
    elif variant == "elastic_preempt":
        from repro_torch.core.autoscale import PreemptingPolicy
        pcfg = PolicyConfig(rescale_gap=rescale_gap,
                            launcher_reserve=launcher_reserve)
        policy = PreemptingPolicy(pcfg)
    else:
        raise ValueError(variant)
    return list(specs), pcfg, policy


def run_variant(variant: str, specs: Sequence[JobSpec], *, total_slots: int,
                rescale_gap: float = 180.0, launcher_reserve: int = 0,
                workload_fn: Callable[[JobSpec], SimWorkload] = None
                ) -> ScheduleMetrics:
    """Run one scheduling policy variant (paper §4.3's four schedulers)."""
    workload_fn = workload_fn or (lambda s: _jacobi_workload_cached(s.workload))
    specs, pcfg, policy = variant_setup(variant, specs,
                                        rescale_gap=rescale_gap,
                                        launcher_reserve=launcher_reserve)
    sim = Simulator(total_slots, pcfg)
    if policy is not None:
        sim.policy = policy
    for s in specs:
        sim.submit(s, workload_fn(s))
    return sim.run()


VARIANTS = ("rigid_min", "rigid_max", "moldable", "elastic")
