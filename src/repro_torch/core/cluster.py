"""Cluster slot accounting + node-aware slot allocation.

Copy of ``repro.core.cluster`` (framework-free).  On one card the
"devices" behind the slots are the trainer's logical ``Slot``s
(``repro_torch.core.elastic.local_slots``).

A *slot* is the malleability quantum: one worker replica (paper: one pod/PE;
here: one logical data-parallel replica).  Every slot belongs to
a concrete node via :class:`~repro_torch.core.placement.PlacementMap`, so kills and
drains displace the jobs actually resident on a node (paper: the operator
kills/drains specific pods on specific nodes), not "some" victims.

Base capacity given at construction becomes one node (``base``) or, with
``slots_per_node``, a row of ``base00..``; a cloud layer (the JAX
package's ``repro.cloud``, not yet ported) attaches and detaches whole nodes via :meth:`add_node` / :meth:`remove_node`.
A spot preemption cordons a node out from under running jobs, so
``free_slots`` can transiently go negative; ``overcommit`` exposes the
deficit the caller must resolve (migrate/shrink/preempt).

Counting (``total/used/free_slots``) stays derived from job replica counts;
the placement map is the concrete slot->node assignment backing it.  The two
agree whenever every replica change goes through :meth:`place`/:meth:`evict`
(property-tested: residency sums equal ``used_slots``).
"""
from __future__ import annotations

from bisect import bisect_left, insort
from typing import Dict, List, Optional, Sequence

from repro_torch.core.job import JobState, JobStatus
from repro_torch.core.placement import PlacementError, PlacementMap

#: statuses that appear in the paper's allJobs list (and in ``_order``)
_SCHEDULABLE = (JobStatus.RUNNING, JobStatus.QUEUED)


class Cluster:
    def __init__(self, total_slots: int, devices: Optional[Sequence] = None,
                 devices_per_slot: int = 1, *,
                 slots_per_node: Optional[int] = None,
                 placement: str = "pack"):
        self.jobs: Dict[str, JobState] = {}
        # fleet-scale accounting, maintained by the JobState watch hook:
        # schedulable jobs in sort_key order (static, unique per job) and the
        # running-replica sum — so running_jobs()/used_slots never scan or
        # re-sort the whole job table.
        self._order: List[JobState] = []
        self._running: List[JobState] = []   # RUNNING subset, same order
        # offerable subset, same order: jobs Fig.-3 redistribution could
        # actually hand slots to — queued, or running below max_replicas.
        # Running-at-max jobs (the bulk of a loaded fleet) never enter, so
        # the per-completion scan is O(candidates), not O(running jobs).
        self._offerable: List[JobState] = []
        self._used = 0
        self.devices = list(devices) if devices is not None else None
        self.devices_per_slot = devices_per_slot
        if self.devices is not None:
            assert len(self.devices) >= total_slots * devices_per_slot
        self.placement = PlacementMap(strategy=placement)
        if total_slots > 0:
            if slots_per_node is None:
                self.placement.add_node("base", total_slots)
            else:
                assert slots_per_node >= 1
                i, left = 0, total_slots
                while left > 0:
                    self.placement.add_node(f"base{i:02d}",
                                            min(slots_per_node, left))
                    left -= slots_per_node
                    i += 1

    # --- accounting -------------------------------------------------------
    @property
    def total_slots(self) -> int:
        """Schedulable capacity (cordoned/draining nodes excluded)."""
        return self.placement.total_capacity

    @property
    def used_slots(self) -> int:
        """Running-replica sum, maintained incrementally (stays derived from
        job replica counts, so a job running beyond yanked capacity still
        counts — see ``overcommit``)."""
        return self._used

    @property
    def free_slots(self) -> int:
        return self.total_slots - self.used_slots

    @property
    def overcommit(self) -> int:
        """Slots running beyond capacity (after a node was yanked)."""
        return max(0, self.used_slots - self.total_slots)

    # --- dynamic capacity (cloud node lifecycle) ---------------------------
    def add_node(self, node_id: str, slots: int,
                 zone: Optional[str] = None) -> None:
        assert self.devices is None, \
            "dynamic nodes are unsupported on a device-backed cluster"
        self.placement.add_node(node_id, slots, zone=zone)

    def remove_node(self, node_id: str) -> int:
        """Detach an EMPTY node's slots.  Callers must displace residents
        first (migrate/shrink/preempt — see the JAX package's spot kills);
        raises :class:`PlacementError` while any job is still resident."""
        if node_id not in self.placement.nodes():
            raise KeyError(node_id)
        return self.placement.remove_node(node_id)

    def cordon(self, node_id: str) -> None:
        """Exclude a node from capacity and new placement (drain begins);
        residents stay until migrated/evicted."""
        self.placement.cordon(node_id)

    def uncordon(self, node_id: str) -> None:
        self.placement.uncordon(node_id)

    def is_cordoned(self, node_id: str) -> bool:
        return self.placement.is_cordoned(node_id)

    @property
    def node_count(self) -> int:
        return self.placement.node_count

    def nodes(self) -> List[str]:
        return self.placement.nodes()

    def residents(self, node_id: str) -> Dict[str, int]:
        """job_id -> slots resident on this node (kill/drain blast set)."""
        return self.placement.residents(node_id)

    def resident_count(self, node_id: str) -> int:
        return self.placement.resident_count(node_id)

    def fragmentation(self) -> float:
        """Free-capacity stranding (see PlacementMap.fragmentation)."""
        return self.placement.fragmentation()

    def zone_of(self, node_id: str) -> str:
        return self.placement.zone_of(node_id)

    def job_zones(self, job_id: str) -> Dict[str, int]:
        """zone -> slots the job holds there (correlated blast footprint)."""
        return self.placement.job_zones(job_id)

    def add_job(self, job: JobState):
        assert job.job_id not in self.jobs, job.job_id
        self.jobs[job.job_id] = job
        # account whatever state the job arrives in (tests hand-build RUNNING
        # jobs with preset replicas to model overcommit), then watch it
        if job.status in _SCHEDULABLE:
            self._order_insert(self._order, job)
            if self._offer(job, job.status, job.replicas):
                self._order_insert(self._offerable, job)
        if job.status == JobStatus.RUNNING:
            self._order_insert(self._running, job)
            self._used += job.replicas
        job._watch = self

    # -- JobState watch hook -------------------------------------------------
    @staticmethod
    def _order_insert(order: List[JobState], job: JobState) -> None:
        insort(order, job, key=JobState.sort_key)

    @staticmethod
    def _order_remove(order: List[JobState], job: JobState) -> None:
        i = bisect_left(order, job.sort_key(), key=JobState.sort_key)
        # sort_key is unique per job, so this is the only candidate index
        if i < len(order) and order[i] is job:
            del order[i]

    @staticmethod
    def _offer(job: JobState, status, replicas: int) -> bool:
        """Could redistribution hand this job slots?  Queued jobs always;
        running jobs only below their max size (the policy's side-effect-free
        saturation test, evaluated incrementally instead of per scan)."""
        return status == JobStatus.QUEUED or (
            status == JobStatus.RUNNING
            and replicas < job.spec.max_replicas)

    def _job_changed(self, job: JobState, field: str, old, new) -> None:
        """Called by the watched ``status``/``replicas`` properties on every
        transition of a job this cluster owns: O(log jobs) bookkeeping in
        place of O(jobs) scans at every query."""
        if field == "status":
            if (old in _SCHEDULABLE) != (new in _SCHEDULABLE):
                if new in _SCHEDULABLE:
                    self._order_insert(self._order, job)
                else:
                    self._order_remove(self._order, job)
            r = job.replicas
            if self._offer(job, old, r) != self._offer(job, new, r):
                if self._offer(job, new, r):
                    self._order_insert(self._offerable, job)
                else:
                    self._order_remove(self._offerable, job)
            if old == JobStatus.RUNNING:
                self._order_remove(self._running, job)
                self._used -= job.replicas
            elif new == JobStatus.RUNNING:
                self._order_insert(self._running, job)
                self._used += job.replicas
        elif field == "replicas" and job.status == JobStatus.RUNNING:
            self._used += new - old
            mx = job.spec.max_replicas
            if (old < mx) != (new < mx):
                if new < mx:
                    self._order_insert(self._offerable, job)
                else:
                    self._order_remove(self._offerable, job)

    def running_jobs(self) -> List[JobState]:
        """Sorted by DECREASING priority (paper's runningJobs list)."""
        return list(self._running)

    def queued_jobs(self) -> List[JobState]:
        return [j for j in self._order if j.status == JobStatus.QUEUED]

    def all_schedulable_jobs(self) -> List[JobState]:
        """Running + queued, decreasing priority (paper's allJobs list)."""
        return list(self._order)

    def offerable_jobs(self) -> List[JobState]:
        """The schedulable jobs that could accept slots (queued, or running
        below max), same priority order — what Fig.-3 redistribution scans.
        Jobs the policy would skip via its saturation test are pre-filtered
        here incrementally, so the scan no longer touches every running job
        on every completion."""
        return list(self._offerable)

    # --- node-backed slot assignment ---------------------------------------
    def can_place(self, n: int) -> bool:
        return self.placement.free() >= n

    def place(self, job_id: str, n: int,
              strategy: Optional[str] = None) -> List[int]:
        """Assign n concrete node-backed slots (strategy: pack/spread);
        returns slot indices (stable per node, contiguous within a node —
        the ICI-locality analog of the paper's pod affinity)."""
        return self.placement.place(job_id, n, strategy)

    def evict(self, job_id: str, n: Optional[int] = None,
              prefer: Optional[str] = None) -> List[int]:
        """Free n of a job's slots (all when None), draining/preferred nodes
        first; returns the freed indices."""
        return self.placement.evict(job_id, n, prefer)

    def migrate(self, job_id: str, from_node: str) -> int:
        """Relocate the job's slots off ``from_node`` onto free capacity
        elsewhere; returns how many moved."""
        return self.placement.migrate(job_id, from_node)

    # --- compat aliases (live operator's device-range view) -----------------
    def allocate_slots(self, job_id: str, n: int) -> List[int]:
        return self.place(job_id, n)

    def release_slots(self, job_id: str, keep: int = 0) -> List[int]:
        """Free all but ``keep`` of a job's slots."""
        owned = self.placement.owned(job_id)
        if owned <= keep:
            return []
        return self.evict(job_id, owned - keep)

    def slots_of(self, job_id: str) -> List[int]:
        return self.placement.slots_of(job_id)

    def devices_for_slots(self, slots: Sequence[int]) -> list:
        assert self.devices is not None
        out = []
        for s in slots:
            out.extend(self.devices[s * self.devices_per_slot:
                                    (s + 1) * self.devices_per_slot])
        return out
