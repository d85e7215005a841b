"""Canonical workload traces: one record type, many sources.

Copy of ``repro.workloads.trace`` (framework-free), line for line, so both
packages give bit-equal results on the same inputs.

A :class:`Trace` is an immutable, ordered stream of :class:`TraceJob`
arrivals.  Everything downstream — characterization (``stats``), replay
through the simulators (``replay``), the table4 benchmark — consumes this one
type, so a Google-style CSV, an Azure-style CSV, and a seeded synthetic
generator are interchangeable workload descriptions.

Loader adapters accept the *shape* of the public traces (column names are
alias-tolerant), not their multi-GB originals:

- Google cluster-usage style (``load_google_trace``): microsecond timestamps,
  per-task CPU request as a fraction of one machine, priority 0..11;
- Azure VM style (``load_azure_trace``): second-granularity created/deleted
  lifetimes, integer core counts, workload category (Interactive /
  Delay-insensitive / Unknown).

Normalization passes (each returns a NEW ``Trace``; the raw load is never
mutated) map any source onto the paper's experimental frame: rebase time to
t=0, clamp pathological durations, rescale slot demands to a target cluster
size, and bucket raw priorities into the paper's high/low classes.
"""
from __future__ import annotations

import csv
import math
import os
from dataclasses import dataclass, replace
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

#: priority values of the paper's two job classes (§4.3.1 draws U{1..5};
#: the high/low bucketing collapses a trace's raw levels onto the extremes)
LOW_PRIORITY = 1
HIGH_PRIORITY = 5


@dataclass(frozen=True)
class TraceJob:
    """One job arrival: open-loop submit time, observed resource request, and
    the runtime it achieved at that request (the replay layer turns the pair
    into a strong-scaling model around this "natural" size)."""
    job_id: str
    submit_time: float          # seconds from trace start
    duration: float             # seconds of runtime observed at ``slots``
    slots: int                  # resource request (replicas at natural size)
    priority: int               # raw source priority (bucket before replay)
    user: str = ""

    def __post_init__(self):
        assert self.duration > 0.0, self
        assert self.slots >= 1, self

    @property
    def slot_seconds(self) -> float:
        return self.duration * self.slots


@dataclass(frozen=True)
class Trace:
    name: str
    jobs: Tuple[TraceJob, ...]
    source: str = "synthetic"   # file path for loaded traces

    # -- views ---------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.jobs)

    def __iter__(self):
        return iter(self.jobs)

    @property
    def horizon(self) -> float:
        """Last arrival time (arrival horizon, not completion)."""
        return max((j.submit_time for j in self.jobs), default=0.0)

    @property
    def slot_seconds(self) -> float:
        return sum(j.slot_seconds for j in self.jobs)

    def arrivals(self) -> List[float]:
        return [j.submit_time for j in self.jobs]

    # -- normalization passes (each returns a new Trace) ---------------------
    def sorted(self) -> "Trace":
        """Canonical arrival order: time, then job_id for ties."""
        return replace(self, jobs=tuple(sorted(
            self.jobs, key=lambda j: (j.submit_time, j.job_id))))

    def rebase_time(self) -> "Trace":
        """Shift arrivals so the first lands at t=0 (real traces start at an
        arbitrary epoch offset)."""
        if not self.jobs:
            return self
        t0 = min(j.submit_time for j in self.jobs)
        return replace(self, jobs=tuple(
            replace(j, submit_time=j.submit_time - t0) for j in self.jobs))

    def clamp_durations(self, lo: float, hi: float) -> "Trace":
        """Clip runtimes into [lo, hi] — public traces carry sub-second crash
        loops and weeks-long services, both meaningless at benchmark scale."""
        assert 0.0 < lo <= hi
        return replace(self, jobs=tuple(
            replace(j, duration=min(max(j.duration, lo), hi))
            for j in self.jobs))

    def rescale_slots(self, cluster_slots: int,
                      max_fraction: float = 0.5) -> "Trace":
        """Linearly rescale slot demands so the LARGEST request equals
        ``max_fraction`` of a ``cluster_slots`` cluster (floor 1).  Preserves
        the relative size distribution — the tail stays a tail — while
        guaranteeing every job is individually satisfiable."""
        assert cluster_slots >= 1 and 0.0 < max_fraction <= 1.0
        if not self.jobs:
            return self
        peak = max(j.slots for j in self.jobs)
        factor = max(1, int(cluster_slots * max_fraction)) / peak
        return replace(self, jobs=tuple(
            replace(j, slots=max(1, round(j.slots * factor)))
            for j in self.jobs))

    def bucket_priorities(self, high_fraction: float = 0.3,
                          low: int = LOW_PRIORITY,
                          high: int = HIGH_PRIORITY) -> "Trace":
        """Collapse raw source priorities onto the paper's two classes: the
        top ``high_fraction`` of raw levels (by quantile) become ``high``,
        the rest ``low``.  Degenerate traces (one raw level) go all-low."""
        assert 0.0 <= high_fraction <= 1.0
        if not self.jobs:
            return self
        raw = np.array([j.priority for j in self.jobs], dtype=float)
        if high_fraction == 1.0:
            cut = -math.inf
        elif raw.min() == raw.max() or high_fraction == 0.0:
            cut = math.inf
        else:
            cut = float(np.quantile(raw, 1.0 - high_fraction))
            if cut <= raw.min():        # mass at the bottom: strict threshold
                cut = raw.min() + 0.5
        return replace(self, jobs=tuple(
            replace(j, priority=high if j.priority >= cut else low)
            for j in self.jobs))

    def truncate(self, n_jobs: int) -> "Trace":
        """Keep the first ``n_jobs`` arrivals (call on a sorted trace)."""
        return replace(self, jobs=self.jobs[:n_jobs])

    def normalized(self, cluster_slots: int, *, max_fraction: float = 0.5,
                   min_duration: float = 30.0, max_duration: float = 3600.0,
                   high_fraction: float = 0.3,
                   n_jobs: Optional[int] = None) -> "Trace":
        """The standard pipeline every source goes through before replay:
        sort -> truncate -> rebase -> clamp -> rescale -> bucket."""
        t = self.sorted()
        if n_jobs is not None:
            t = t.truncate(n_jobs)
        return (t.rebase_time()
                 .clamp_durations(min_duration, max_duration)
                 .rescale_slots(cluster_slots, max_fraction)
                 .bucket_priorities(high_fraction))


# ---------------------------------------------------------------------------
# CSV loader adapters
# ---------------------------------------------------------------------------

def _col(row: Dict[str, str], *names: str) -> str:
    """Alias-tolerant column lookup (public trace dumps disagree on names)."""
    for n in names:
        if n in row and row[n] != "":
            return row[n]
    raise KeyError(f"none of {names} present in columns {sorted(row)}")


def load_google_trace(path: str, *, slots_per_machine: int = 8) -> Trace:
    """Google cluster-usage-style CSV: one row per task, microsecond
    timestamps, CPU request as a fraction of one machine.

    Expected (alias-tolerant) header columns::

        time|timestamp          submission time, microseconds
        job_id|collection_id    job identifier
        duration|duration_us    observed runtime, microseconds
        cpu_request|resource_request_cpus   fraction of one machine [0, 1+]
        priority                0..11 (larger = more important)
        user                    optional

    ``slots`` is the CPU request projected onto a machine of
    ``slots_per_machine`` schedulable slots (ceil, floor 1).
    """
    jobs = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            cpu = float(_col(row, "cpu_request", "resource_request_cpus"))
            jobs.append(TraceJob(
                job_id=str(_col(row, "job_id", "collection_id")),
                submit_time=float(_col(row, "time", "timestamp")) * 1e-6,
                duration=float(_col(row, "duration", "duration_us")) * 1e-6,
                slots=max(1, math.ceil(cpu * slots_per_machine)),
                priority=int(_col(row, "priority")),
                user=row.get("user", ""),
            ))
    return Trace(name=_stem(path), jobs=tuple(jobs), source=path)


#: Azure VM categories -> raw priority (bucket_priorities maps these to the
#: paper's classes; Interactive VMs are the latency-sensitive ones)
AZURE_CATEGORY_PRIORITY = {"interactive": 2, "unknown": 1,
                           "delay-insensitive": 0}


def load_azure_trace(path: str) -> Trace:
    """Azure VM-style CSV: one row per VM lifetime, second timestamps.

    Expected (alias-tolerant) header columns::

        vm_id                               VM identifier
        vm_created / vm_deleted             lifetime bounds, seconds
        vm_virtual_core_count|core_count    integer cores -> slots
        vm_category|category                Interactive / Delay-insensitive /
                                            Unknown (or a numeric priority)
        subscription_id                     optional -> user
    """
    jobs = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            created = float(_col(row, "vm_created", "created"))
            deleted = float(_col(row, "vm_deleted", "deleted"))
            if deleted <= created:
                continue    # censored lifetime: VM still alive at the
                #             snapshot end (deleted == created or 0) — no
                #             observed duration to replay, skip the row
            cat = _col(row, "vm_category", "category", "priority")
            try:
                prio = int(cat)
            except ValueError:
                prio = AZURE_CATEGORY_PRIORITY[cat.strip().lower()]
            jobs.append(TraceJob(
                job_id=str(_col(row, "vm_id", "id")),
                submit_time=created,
                duration=deleted - created,
                slots=max(1, int(float(
                    _col(row, "vm_virtual_core_count", "core_count",
                         "cores")))),
                priority=prio,
                user=row.get("subscription_id", ""),
            ))
    return Trace(name=_stem(path), jobs=tuple(jobs), source=path)


LOADERS = {"google": load_google_trace, "azure": load_azure_trace}


def _stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def fixture_path(name: str) -> str:
    """Path to a bundled sample trace (checked-in CSV under fixtures/)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", name)
