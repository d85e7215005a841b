"""Elastic training runtime and live scheduler of the port (paper C1, C2).

- C1 (shrink/expand):   core.elastic.ElasticTrainer
- C2 (operator+policy): core.operator.ElasticClusterController, core.policies

The JAX package's simulator (C3) and ``autoscale`` policies are not ported
yet; the operator builds a plain :class:`ElasticPolicy`.
"""
from repro_torch.core.cluster import Cluster
from repro_torch.core.elastic import (ElasticTrainer, RescaleTimings, Slot,
                                      TrainJobConfig, local_slots)
from repro_torch.core.job import JobSpec, JobState, JobStatus
from repro_torch.core.metrics import (ScheduleMetrics, UtilizationLog,
                                      compute_metrics)
from repro_torch.core.operator import ElasticClusterController
from repro_torch.core.placement import PlacementError, PlacementMap
from repro_torch.core.policies import Actions, ElasticPolicy, PolicyConfig

__all__ = [
    "Cluster", "ElasticTrainer", "RescaleTimings", "Slot", "TrainJobConfig",
    "local_slots", "JobSpec", "JobState", "JobStatus", "ScheduleMetrics",
    "UtilizationLog", "compute_metrics", "ElasticClusterController",
    "PlacementError", "PlacementMap", "Actions", "ElasticPolicy",
    "PolicyConfig",
]
