"""Job model: spec (user-provided) + state (scheduler-owned).

Copy of ``repro.core.job`` (framework-free).

Priority semantics (paper §3.2.1): larger integer = more important; ties are
FCFS by submission time.  ``sort_key`` orders decreasing priority.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field, replace
from typing import Any, Optional


class JobStatus(enum.Enum):
    PENDING = "pending"        # submitted, not yet scheduled
    QUEUED = "queued"          # could not start; in the internal priority queue
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"


@dataclass(frozen=True)
class JobSpec:
    job_id: str
    priority: int
    min_replicas: int
    max_replicas: int
    submit_time: float = 0.0
    # workload description — consumed by the perf model (simulator) or by the
    # live runtime (arch/config/steps for a real training job).
    workload: Any = None
    # data-parallel feasibility: live training jobs keep a fixed global
    # batch, so the replica count must divide it.  None = unconstrained
    # (the paper's Charm++ jobs accept any count via overdecomposition).
    divides: Optional[int] = None

    def __post_init__(self):
        assert 1 <= self.min_replicas <= self.max_replicas, self
        if self.divides is not None:
            assert self.feasible(self.min_replicas) == self.min_replicas, \
                f"min_replicas must divide {self.divides}"
            assert self.feasible(self.max_replicas) == self.max_replicas, \
                f"max_replicas must divide {self.divides}"

    def feasible(self, replicas: int) -> int:
        """Largest feasible replica count <= requested (0 if none)."""
        r = min(replicas, self.max_replicas)
        if self.divides is None:
            return r
        while r >= 1 and self.divides % r:
            r -= 1
        return r

    def rigid(self, replicas: int) -> "JobSpec":
        """Paper §4.3.2: rigid schedulers are emulated by min==max."""
        return replace(self, min_replicas=replicas, max_replicas=replicas)


@dataclass
class JobState:
    spec: JobSpec
    status: JobStatus = JobStatus.PENDING
    replicas: int = 0
    # time of the last scheduling action on this job (T_rescale_gap anchor);
    # queued/pending jobs always pass the gap check (paper Fig. 3 hands slots
    # to queued jobs regardless of how recently they were enqueued).
    last_action: float = -math.inf
    start_time: Optional[float] = None      # first time it got resources
    end_time: Optional[float] = None
    # simulator bookkeeping
    work_remaining: float = 0.0
    last_progress_time: float = 0.0
    overhead_until: float = 0.0
    rescale_count: int = 0
    preempt_count: int = 0
    version: int = 0                        # invalidates stale events
    device_ids: tuple = ()                  # live runtime: allocated devices

    #: observer wired by Cluster.add_job so status/replicas transitions keep
    #: the cluster's incremental accounting (used-slot sum, priority-ordered
    #: schedulable list) in sync without per-query scans.  None (the class
    #: default) on free-standing JobStates: transitions are then plain field
    #: writes, so tests poking at un-added jobs see unchanged behavior.
    _watch = None

    @property
    def job_id(self) -> str:
        return self.spec.job_id

    @property
    def priority(self) -> int:
        return self.spec.priority

    #: cached sort_key tuple — the spec is frozen, so the key never changes
    _key = None

    def sort_key(self):
        """Sorts DECREASING priority; FCFS within a priority level."""
        k = self._key
        if k is None:
            spec = self.spec
            k = self._key = (-spec.priority, spec.submit_time, spec.job_id)
        return k

    def higher_priority_than(self, other: "JobState") -> bool:
        """Strict user-priority comparison (paper's shrink-loop guard uses the
        raw priority field only; FCFS ties do not protect from shrinking)."""
        return self.spec.priority > other.spec.priority


def _watched(name: str):
    """Build a watched property for a JobState field: plain attribute
    semantics, plus a change notification to ``job._watch`` (the owning
    cluster) when one is attached.  Installed AFTER the @dataclass decorator
    runs so the generated ``__init__``/``repr``/``eq`` assign and read
    through it transparently."""
    priv = "_" + name

    def _get(self):
        return self.__dict__[priv]

    def _set(self, value):
        d = self.__dict__
        old = d.get(priv)
        d[priv] = value
        w = self._watch
        if w is not None and old != value:
            w._job_changed(self, name, old, value)

    return property(_get, _set, doc=f"watched dataclass field {name!r}")


JobState.status = _watched("status")
JobState.replicas = _watched("replicas")


def response_time(job: JobState) -> Optional[float]:
    if job.start_time is None:
        return None
    return job.start_time - job.spec.submit_time


def completion_time(job: JobState) -> Optional[float]:
    if job.end_time is None:
        return None
    return job.end_time - job.spec.submit_time
