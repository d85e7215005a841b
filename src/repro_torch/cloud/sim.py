"""Discrete-event simulator over a :class:`CloudProvider`: dynamic capacity,
spot preemption, node autoscaling, and cost accounting.

Copy of ``repro.cloud.sim`` (framework-free), line for line, so both
packages give bit-equal results on the same inputs.

Extends :class:`repro_torch.core.simulator.Simulator` with five event kinds:

- ``node_up``        capacity attaches; queued jobs get a Fig.-3 offer pass
- ``node_down``      a drained node's billing stops
- ``spot_kill``      a spot node vanishes NOW; placement makes the blast set
                     exact: only the jobs RESIDENT on the killed node are
                     displaced — their workers migrate to free slots
                     elsewhere when any exist, else shrink toward
                     min_replicas (lowest priority first), else checkpoint-
                     to-disk preempt via the same ``Actions.preempt`` path
                     PreemptingPolicy uses (victims requeue and later resume
                     with progress intact)
- ``zone_reclaim``   a correlated burst: the provider picks a fraction of a
                     zone's UP spot nodes and this sim replays them as a
                     BATCH of node-exact kills — every victim node is
                     cordoned up front (one event, one blast domain), so a
                     displaced worker is never migrated onto a node dying in
                     the same burst; on-demand nodes and other zones are
                     bystanders
- ``autoscale_tick`` the NodeAutoscaler evaluates queue pressure / idleness

Region awareness rides on the preempt/resume path: a checkpoint written by a
preempted job remembers its region (the region hosting the plurality of its
slots), and a resume whose new home is in a DIFFERENT region bills the
checkpoint footprint as inter-region transfer (CostAccountant.bill_transfer).

Scale-down is drain-aware: :meth:`CloudSimulator.begin_drain` cordons a node,
migrates its residents onto free capacity elsewhere (each migrated job pays a
footprint-scaled rescale overhead), and decommissions once empty; the
autoscaler retries the drain every tick until it completes (migrate-or-wait).

Cost integration piggybacks on ``_record_util``: every allocation or capacity
boundary advances the :class:`CostAccountant` under the rates that held since
the previous boundary.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

from repro_torch.cloud.cost import CostAccountant, CostReport
from repro_torch.cloud.node_autoscaler import NodeAutoscaler
from repro_torch.cloud.provider import SPOT, CloudProvider, NodeState
from repro_torch.core.job import JobSpec, JobStatus
from repro_torch.core.metrics import ScheduleMetrics
from repro_torch.core.policies import PolicyConfig
from repro_torch.core.simulator import Simulator, SimWorkload, _SimActions


class KillBlast(NamedTuple):
    """Per effective spot kill: what one node's reclaim displaced.  A plain
    tuple extension of the PR-2 (jobs, slots, preempts) record, so existing
    index-based consumers keep working; ``zone`` attributes the kill to its
    failure domain (correlated reclaims land many same-zone rows at one
    timestamp)."""
    jobs: int           # jobs displaced (the node's residents)
    slots: int          # slots displaced
    preempts: int       # of those jobs, how many were checkpoint-preempted
    zone: str           # failure zone of the killed node


class _CloudActions(_SimActions):
    """Region-aware actions: remember where a preempted job's checkpoint was
    written; bill inter-region transfer when it resumes elsewhere.  Every
    preempt/resume also bills its checkpoint write/restore slot-time to the
    accountant's preemption-overhead item, and resumes of KILL-caused
    preemptions feed the follow-up cost (restore, outage lost-work,
    transfer) back to the spot-risk ledger of the killing zone."""

    def preempt(self, job) -> bool:
        region = self.sim.job_region(job.job_id)    # before slots are freed
        replicas = job.replicas
        ok = super().preempt(job)
        if ok:
            # bill exactly the checkpoint the base preempt charged the clock
            dollars = self.sim.accountant.bill_preempt_overhead(
                job.job_id, self.sim.last_preempt_ckpt_s, replicas)
            if self.sim.tracer.enabled:
                self.sim.tracer.emit(
                    "cost_preempt_overhead", t=self.sim.now, job=job.job_id,
                    dollars=dollars,
                    slot_s=self.sim.last_preempt_ckpt_s * replicas,
                    phase="ckpt")
            if region is not None:
                self.sim._ckpt_region[job.job_id] = region
        return ok

    def create(self, job, replicas: int) -> bool:
        wl = self.sim.workloads[job.job_id]
        ok = super().create(job, replicas)
        if ok:
            xfer = 0.0
            src = self.sim._ckpt_region.pop(job.job_id, None)
            dst = self.sim.job_region(job.job_id) if src is not None else None
            if src is not None and dst is not None and dst != src:
                xfer = self.sim.accountant.bill_transfer(
                    job.job_id, wl.data_bytes,
                    self.sim.provider.transfer_price_per_gb)
                if self.sim.tracer.enabled:
                    self.sim.tracer.emit("cost_transfer", t=self.sim.now,
                                         job=job.job_id, dollars=xfer)
            # bill exactly the restore the base create charged the clock
            # (0 unless this create resumed a preempted job)
            restore_dollars = 0.0
            if self.sim.last_resume_s > 0.0:
                restore_dollars = self.sim.accountant.bill_preempt_overhead(
                    job.job_id, self.sim.last_resume_s, replicas)
                if self.sim.tracer.enabled:
                    self.sim.tracer.emit(
                        "cost_preempt_overhead", t=self.sim.now,
                        job=job.job_id, dollars=restore_dollars,
                        slot_s=self.sim.last_resume_s * replicas,
                        phase="restore")
            kill = self.sim._kill_zone.pop(job.job_id, None)
            if kill is not None and self.sim.risk_ledger is not None:
                zone, killed_at, killed_reps = kill
                # lost work: the outage window in victim slot-seconds (the
                # job produced nothing between kill and resume), priced at
                # the blended rate the accountant exposes
                outage = max(0.0, self.sim.now - killed_at)
                lost_s = outage * killed_reps
                self.sim.risk_ledger.record_cost(
                    zone, self.sim.now,
                    dollars=(restore_dollars + lost_s *
                             self.sim.accountant.blended_slot_rate()),
                    lost_seconds=lost_s, transfer_dollars=xfer)
        return ok


class CloudSimulator(Simulator):
    def __init__(self, provider: CloudProvider, policy_cfg: PolicyConfig,
                 *, autoscaler: Optional[NodeAutoscaler] = None,
                 policy=None, placement: str = "pack", tracer=None,
                 profiler=None):
        # all capacity comes from nodes; `placement` picks the slot->node
        # strategy (pack: low fragmentation; spread: small kill blast radius)
        super().__init__(0, policy_cfg, placement=placement, tracer=tracer,
                         profiler=profiler)
        if policy is not None:
            self.policy = policy
        self.provider = provider
        self.autoscaler = autoscaler
        self.actions = _CloudActions(self)  # region-aware preempt/resume
        self.accountant = CostAccountant()
        self.cost_report: Optional[CostReport] = None
        self.spot_victim_jobs = 0           # job preemptions caused by kills
        self.migrations = 0                 # jobs relocated off dying nodes
        self.zone_reclaims = 0              # correlated events that drew blood
        self.kill_blasts: List[KillBlast] = []
        # per correlated EVENT: union of the batch's displaced residents —
        # the per-node rows in kill_blasts understate correlation (a job
        # losing 2 slots on each of 3 dying nodes is one 6-slot casualty)
        self.zone_blasts: List[KillBlast] = []
        self._ckpt_region: Dict[str, str] = {}   # preempted job -> ckpt home
        # demand-aware bidding: the bidder rides on the autoscaler config;
        # its risk ledger consumes kill/resume costs this sim attributes
        self.bidder = autoscaler.cfg.bidder if autoscaler is not None else None
        self.risk_ledger = self.bidder.ledger if self.bidder is not None \
            else None
        # kill-preempted job -> (zone, kill time, replicas at kill): resume
        # attributes its follow-up cost back to the zone that caused it
        self._kill_zone: Dict[str, tuple] = {}
        self._expected_jobs = 0
        for node in provider.bootstrap(self.queue):
            self.cluster.add_node(node.node_id, node.slots,
                                  zone=node.pool.zone)
            self.accountant.node_up(node)
            self._trace_node_up(node)
        provider.schedule_zone_reclaims(self.queue)
        self.util.record_capacity(0.0, self.cluster.total_slots)
        if autoscaler is not None:
            self.queue.push(0.0, "autoscale_tick", None)

    # -- bookkeeping hooks ---------------------------------------------------
    def _trace_node_up(self, node) -> None:
        # boot window feeds the phase decomposition: initial queue wait that
        # overlaps a node's request->up interval is boot_wait, not queue_wait
        self.phases.note_boot_window(node.requested_at, self.now)
        if self.tracer.enabled:
            self.tracer.emit("node_up", t=self.now, node=node.node_id,
                             slots=node.slots, zone=node.pool.zone,
                             region=node.pool.region, market=node.pool.market,
                             price_per_slot_hour=node.pool.price_per_slot_hour,
                             boot_s=self.now - node.requested_at)

    def _wire_decisions(self) -> None:
        super()._wire_decisions()
        from repro_torch.obs.decisions import DecisionLog
        log = DecisionLog(self.tracer)
        if self.autoscaler is not None and self.autoscaler.decisions is None:
            self.autoscaler.decisions = log
        if self.bidder is not None and self.bidder.decisions is None:
            self.bidder.decisions = log

    def _record_util(self):
        # integrate [last boundary, now] under the OLD allocations/rates,
        # then snapshot the new allocation state
        self.accountant.advance(self.now)
        super()._record_util()
        self.accountant.set_allocations(self.cluster.running_jobs())

    def _record_capacity(self):
        self.util.record_capacity(self.now, self.cluster.total_slots)
        self._record_util()

    def _sync_all(self):
        """Bring every running job's progress up to ``now``.  No event
        handler calls this anymore (the fleet-scale refactor made progress
        sync lazy: mutators sync their own victims, and policies that read
        ``work_remaining`` pull it through ``sync_job``); kept as a debugging
        aid for extensions that want a globally-consistent snapshot."""
        for j in self.cluster.running_jobs():
            self._sync_progress(j)

    def _all_done(self) -> bool:
        jobs = self.cluster.jobs
        return (len(jobs) >= self._expected_jobs and
                all(j.status is JobStatus.COMPLETED for j in jobs.values()))

    def _should_stop(self) -> bool:
        # the experiment window ends at the last completion; don't bill idle
        # nodes out to their far-future spot fates / teardown events
        if self._all_done():
            return True
        # stuck: every job submitted, nothing running, nothing booting, and
        # no autoscaler able to make progress — the queued remainder can
        # never start, so stop instead of billing to the next far-future
        # event.  With an autoscaler, "able to make progress" means some
        # queued job fits the pools' theoretical ceiling (the autoscaler can
        # provision toward it); past max_horizon nothing provisions either.
        jobs = self.cluster.jobs
        if (len(jobs) < self._expected_jobs
                or any(j.status is JobStatus.RUNNING for j in jobs.values())
                or self.provider.nodes_in(NodeState.PROVISIONING)):
            return False
        if self.autoscaler is None:
            return True
        if self.now >= self.autoscaler.cfg.max_horizon:
            return True
        max_slots = self.provider.theoretical_max_slots()
        return all(j.spec.min_replicas > max_slots
                   for j in self.cluster.queued_jobs())

    # -- API -----------------------------------------------------------------
    def submit(self, spec: JobSpec, workload: SimWorkload):
        self._expected_jobs += 1
        super().submit(spec, workload)

    def _final_metrics(self) -> ScheduleMetrics:
        metrics = super()._final_metrics()
        self.accountant.advance(self.now)
        self.cost_report = self.accountant.report()
        r = self.cost_report

        def _blast_stats(kills: List[KillBlast]):
            if not kills:
                return 0.0, 0.0, 0.0
            n = float(len(kills))
            # damage concentration: displaced slots per victim job, averaged
            # over kills (kills that hit empty nodes contribute 0)
            return (sum(k.jobs for k in kills) / n,
                    sum(k.slots / k.jobs for k in kills if k.jobs) / n,
                    sum(k.preempts for k in kills) / n)
        blast_jobs, blast_radius, preempts = _blast_stats(self.kill_blasts)
        zb_jobs, _, zb_preempts = _blast_stats(self.zone_blasts)
        # weighted, not mean-of-ratios: how many slots the average CASUALTY
        # lost to a correlated event (events that only hit empty nodes carry
        # no casualties and must not dilute the damage statistic)
        zb_victims = sum(k.jobs for k in self.zone_blasts)
        zb_radius = (sum(k.slots for k in self.zone_blasts) / zb_victims
                     if zb_victims else 0.0)
        return dataclasses.replace(
            metrics, total_cost=r.total_cost, idle_cost=r.idle_cost,
            node_hours=r.node_hours, spot_preemptions=r.spot_preemptions,
            transfer_cost=r.transfer_cost, zone_reclaims=self.zone_reclaims,
            kill_blast_jobs=blast_jobs, kill_blast_radius=blast_radius,
            kill_preemptions=preempts, zone_blast_jobs=zb_jobs,
            zone_blast_radius=zb_radius, zone_preemptions=zb_preempts,
            preempt_overhead_cost=r.preempt_overhead_cost,
            bid_adjustments=(self.bidder.adjustments
                             if self.bidder is not None else 0),
            spot_share_by_zone=self.spot_share_by_zone())

    def spot_share_by_zone(self) -> Dict[str, float]:
        """Observed (not bid) per-zone spot share: spot slot-hours billed in
        each zone over ALL billed slot-hours — what the fleet actually held,
        for comparison against the bidder's emitted quotas."""
        total = sum(n.slots * n.billed_hours(self.now)
                    for n in self.provider.nodes.values())
        if total <= 0.0:
            return {}
        per: Dict[str, float] = {}
        for n in self.provider.nodes.values():
            if n.pool.market == SPOT:
                h = n.slots * n.billed_hours(self.now)
                if h > 0.0:
                    per[n.pool.zone] = per.get(n.pool.zone, 0.0) + h
        return {z: h / total for z, h in sorted(per.items())}

    def job_region(self, job_id: str) -> Optional[str]:
        """Region hosting the plurality of the job's slots (checkpoint home
        for transfer billing); None while the job holds no slots."""
        per: Dict[str, int] = {}
        for nid, cnt in self.cluster.placement.job_nodes(job_id).items():
            r = self.provider.region_of(nid)
            per[r] = per.get(r, 0) + cnt
        if not per:
            return None
        return max(sorted(per), key=lambda r: per[r])

    def decommission(self, node_id: str) -> bool:
        """Voluntarily release an EMPTY node (autoscaler scale-down).  The
        capacity leaves the scheduler now; billing runs through teardown.
        Drain-aware guard: returns False while jobs are still resident
        (callers drain via :meth:`begin_drain`) instead of crashing."""
        if self.cluster.residents(node_id):
            return False
        self._record_util()                       # close the interval first
        self.cluster.remove_node(node_id)
        self.provider.release_node(node_id, self.now, self.queue)
        self._record_capacity()
        if self.tracer.enabled:
            self.tracer.emit("node_removed", t=self.now, node=node_id)
        return True

    # -- drain (graceful scale-down) -----------------------------------------
    def begin_drain(self, node_id: str) -> bool:
        """Cordon a node and try to empty it by migrating residents onto free
        slots elsewhere; decommission once empty.  Returns True when the node
        was released, False while residents remain (caller retries next tick
        — migrate-or-wait)."""
        if node_id not in self.cluster.nodes():
            return True                           # spot market beat us to it
        if not self.cluster.is_cordoned(node_id):
            self._record_util()
            if self.tracer.enabled:
                self.tracer.emit("node_cordon", t=self.now, node=node_id,
                                 slots=self.provider.nodes[node_id].slots,
                                 cause="drain")
            self.cluster.cordon(node_id)
            self._record_capacity()               # capacity leaves now
        residents = self.cluster.residents(node_id)
        for job_id in sorted(residents,
                             key=lambda i: self.cluster.jobs[i].sort_key()):
            self._migrate_job(self.cluster.jobs[job_id], node_id)
        return self.decommission(node_id)

    def cancel_drain(self, node_id: str) -> None:
        """Queue pressure returned mid-drain: put the capacity back."""
        if self.cluster.is_cordoned(node_id):
            self._record_util()
            self.cluster.uncordon(node_id)
            self._record_capacity()
            if self.tracer.enabled:
                self.tracer.emit("node_uncordon", t=self.now, node=node_id,
                                 slots=self.provider.nodes[node_id].slots)

    def _migrate_job(self, job, node_id: str) -> int:
        """Relocate a running job's workers off ``node_id`` onto free slots
        elsewhere.  The moved workers checkpoint/restart on their new homes:
        the job pays the rescale-model overhead scaled by the fraction of its
        replicas that moved."""
        if job.status is not JobStatus.RUNNING or job.replicas <= 0:
            return 0
        moved = self.cluster.migrate(job.job_id, node_id)
        if moved:
            self._sync_progress(job)
            wl = self.workloads[job.job_id]
            overhead = (wl.rescale.total(job.replicas, job.replicas,
                                         wl.data_bytes)
                        * moved / job.replicas)
            job.overhead_until = max(self.now, job.overhead_until) + overhead
            self.total_overhead += overhead
            self.migrations += 1
            self.counters.inc("migrations")
            self.phases.on_migrate(job.job_id, self.now, overhead)
            if self.tracer.enabled:
                self.tracer.emit("job_migrate", t=self.now, job=job.job_id,
                                 from_node=node_id, moved=moved,
                                 overhead_s=overhead)
            self._schedule_completion(job)
            self._record_util()
        return moved

    # -- cloud event kinds ---------------------------------------------------
    def _handle_event(self, ev) -> None:
        if ev.kind == "node_up":
            self._on_node_up(ev.payload)
        elif ev.kind == "node_down":
            node = self.provider.on_node_down(ev.payload, self.now)
            if node is not None:
                self._record_util()               # integrate, then drop rate
                self.accountant.node_down(node)
                if self.tracer.enabled:
                    self.tracer.emit("node_billing_end", t=self.now,
                                     node=node.node_id, cause="teardown")
        elif ev.kind == "spot_kill":
            self._on_spot_kill(ev.payload)
        elif ev.kind == "zone_reclaim":
            self._on_zone_reclaim(ev.payload)
        elif ev.kind == "autoscale_tick":
            self._on_autoscale_tick()
        else:
            super()._handle_event(ev)

    def _on_node_up(self, node_id: str) -> None:
        node = self.provider.on_node_up(node_id, self.now)
        if node is None:
            return                                # killed while booting
        self._record_util()                       # close interval at old rate
        self.accountant.node_up(node)
        self._trace_node_up(node)
        self.cluster.add_node(node.node_id, node.slots, zone=node.pool.zone)
        self._record_capacity()
        # fresh capacity is a completion-shaped opportunity: run the Fig. 3
        # redistribution so queued jobs start / running jobs expand
        self.policy.on_job_complete(self.cluster, node.slots, self.now,
                                    self.actions)

    def _on_spot_kill(self, node_id: str) -> None:
        node, was_up = self.provider.on_spot_kill(node_id, self.now)
        if node is None:
            return                                # stale: already gone
        self._record_util()
        self.accountant.node_down(node, killed=True)
        self.counters.inc("spot_kills")
        if not was_up:
            if self.tracer.enabled:   # was draining: billing only
                self.tracer.emit("node_billing_end", t=self.now,
                                 node=node_id, cause="spot_kill_draining")
            return
        # placement makes the blast set exact: ONLY the jobs resident on the
        # killed node are displaced (paper: the operator loses specific pods
        # on a specific node), never arbitrary victims elsewhere
        victims = dict(self.cluster.residents(node_id))
        # residents parked on OTHER cordoned nodes (an in-flight drain) are
        # that drain's deficit, not this kill's: the postcondition is that
        # the kill adds nothing to it
        pre_overcommit = self.cluster.overcommit
        was_cordoned = self.cluster.is_cordoned(node_id)
        if self.tracer.enabled:
            # opens the blast window the auditor allows transient overcommit
            # in; closed by the matching kill_blast_end below
            self.tracer.emit("spot_kill", t=self.now, node=node_id,
                             slots=node.slots,
                             zone=self.provider.zone_of(node_id),
                             residents=victims, was_cordoned=was_cordoned)
        self.cluster.cordon(node_id)              # capacity is gone NOW
        self._record_capacity()
        by_prio = sorted((self.cluster.jobs[v] for v in victims),
                         key=lambda j: j.sort_key())
        # 1) migrate: free slots elsewhere absorb displaced workers (highest
        #    priority first gets the scarce free capacity)
        for j in by_prio:
            self._migrate_job(j, node_id)
        # 2) shrink still-resident elastic victims toward min, lowest
        #    priority first (forced: the capacity is already gone, so no
        #    gap/priority ceremony); placement.evict vacates the cordoned
        #    node first, so the shrink comes off the dying node exactly
        self._evict_prefer = node_id
        try:
            for j in reversed(by_prio):
                still = self.cluster.residents(node_id).get(j.job_id, 0)
                if still and j.status is JobStatus.RUNNING:
                    target = j.spec.feasible(
                        max(j.spec.min_replicas, j.replicas - still))
                    # only a shrink that clears the job OFF the node helps;
                    # a partial one pays rescale overhead and the job gets
                    # checkpoint-preempted in step 3 regardless
                    if target < j.replicas and target <= j.replicas - still:
                        self.actions.shrink(j, target)
        finally:
            self._evict_prefer = None
        # 3) still resident: checkpoint-to-disk preemption (same path as
        #    PreemptingPolicy), lowest priority first
        zone = self.provider.zone_of(node_id)
        ovh0 = self.accountant.preempt_overhead_cost
        ovh_s0 = self.accountant.preempt_overhead_slot_s
        preempted = 0
        for j in reversed(by_prio):
            if self.cluster.residents(node_id).get(j.job_id, 0):
                reps = j.replicas
                self.actions.preempt(j)
                self.spot_victim_jobs += 1
                preempted += 1
                # resume will attribute restore/outage/transfer to this zone
                self._kill_zone[j.job_id] = (zone, self.now, reps)
        assert not self.cluster.residents(node_id), "spot eviction failed"
        self.cluster.remove_node(node_id)
        assert self.cluster.overcommit <= pre_overcommit, \
            "spot eviction failed"
        self.kill_blasts.append(KillBlast(
            len(victims), sum(victims.values()), preempted, zone))
        if self.tracer.enabled:
            self.tracer.emit("kill_blast_end", t=self.now, node=node_id,
                             jobs=len(victims), slots=sum(victims.values()),
                             preempts=preempted)
        if self.risk_ledger is not None:
            # the kill itself plus the checkpoint dollars its victims just
            # paid (accountant delta — never re-derived here)
            self.risk_ledger.record_kill(
                zone, self.now,
                dollars=self.accountant.preempt_overhead_cost - ovh0,
                lost_seconds=(self.accountant.preempt_overhead_slot_s
                              - ovh_s0))
        # surviving free capacity (shrinks may have overshot node granularity)
        # goes back through the redistribution pass; pass the real free count
        # so pseudocode-faithful configs (redistribute_idle=False) see it too
        free = self.cluster.free_slots
        if free > 0:
            self.policy.on_job_complete(self.cluster, free, self.now,
                                        self.actions)

    def _on_zone_reclaim(self, zone: str) -> None:
        """One correlated reclaim: the provider picks the victims (and re-arms
        the zone's Poisson stream); this sim replays them as a batch of
        node-exact kills.  Cordoning the WHOLE blast set up front keeps the
        per-node displacement honest: a worker migrated off one dying node is
        never parked on another node dying in the same burst."""
        victims = self.provider.on_zone_reclaim(zone, self.now, self.queue)
        if not victims:
            return
        self.zone_reclaims += 1
        self.counters.inc("zone_reclaims")
        if self.tracer.enabled:
            self.tracer.emit("zone_reclaim", t=self.now, zone=zone,
                             victims=list(victims))
        # event-level blast set, captured BEFORE displacement: a preemption
        # during the batch evicts the job everywhere, so later nodes' own
        # resident maps would under-count what this event took from it
        displaced: Dict[str, int] = {}
        for node_id in victims:
            if node_id in self.cluster.nodes():
                for job_id, cnt in self.cluster.residents(node_id).items():
                    displaced[job_id] = displaced.get(job_id, 0) + cnt
                if self.tracer.enabled:
                    self.tracer.emit(
                        "node_cordon", t=self.now, node=node_id,
                        slots=self.provider.nodes[node_id].slots,
                        cause="zone_reclaim")
                self.cluster.cordon(node_id)
        pre_preempts = self.spot_victim_jobs
        for node_id in victims:
            self._on_spot_kill(node_id)
        if self.tracer.enabled:
            self.tracer.emit("zone_reclaim_end", t=self.now, zone=zone)
        self.zone_blasts.append(KillBlast(
            len(displaced), sum(displaced.values()),
            self.spot_victim_jobs - pre_preempts, zone))

    def _on_autoscale_tick(self) -> None:
        if self.autoscaler is None:
            return
        self.counters.inc("autoscale_ticks")
        self.autoscaler.evaluate(self, self.now)
        # CLUES-style periodic queue re-examination: offer free capacity to
        # queued jobs that earlier passes skipped (e.g. a rescale-gap
        # cooldown that has since expired) — without this, a startable job
        # could wait forever if no completion/node event comes
        free = self.cluster.free_slots
        if free > 0 and self.cluster.queued_jobs():
            self.policy.on_job_complete(self.cluster, free, self.now,
                                        self.actions)
        if (not self._all_done()
                and self.now < self.autoscaler.cfg.max_horizon):
            self.queue.push(self.now + self.autoscaler.cfg.tick_interval,
                            "autoscale_tick", None)
