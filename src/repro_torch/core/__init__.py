"""The port's elastic scheduler (paper C1-C3): the runtime that makes
PyTorch training jobs malleable, the live operator that schedules them, and
the discrete-event simulator that evaluates the policy.

- C1 (shrink/expand):   core.elastic.ElasticTrainer
- C2 (operator+policy): core.operator.ElasticClusterController, core.policies
- C3 (simulator):       core.simulator, with its perf models in
                        core.perf_model (an H100 ``ArchScalingModel``)
Beyond-paper:           core.autoscale (aging, cost-benefit, preemption)

The cloud layer (``repro_torch.cloud``) and the trace workloads
(``repro_torch.workloads``) build on these, as in the JAX package.
"""
from repro_torch.core.autoscale import (AgingPolicy, CostBenefitPolicy,
                                        PreemptingPolicy)
from repro_torch.core.cluster import Cluster
from repro_torch.core.elastic import (ElasticTrainer, RescaleTimings, Slot,
                                      TrainJobConfig, local_slots)
from repro_torch.core.job import JobSpec, JobState, JobStatus
from repro_torch.core.metrics import (ScheduleMetrics, UtilizationLog,
                                      compute_metrics)
from repro_torch.core.operator import ElasticClusterController
from repro_torch.core.placement import PlacementError, PlacementMap
from repro_torch.core.policies import Actions, ElasticPolicy, PolicyConfig
from repro_torch.core.simulator import (Simulator, SimWorkload, VARIANTS,
                                        jacobi_workload, make_jacobi_jobs,
                                        run_variant)

__all__ = [
    "AgingPolicy", "CostBenefitPolicy", "PreemptingPolicy", "Cluster",
    "ElasticTrainer", "RescaleTimings", "Slot", "TrainJobConfig",
    "local_slots", "JobSpec", "JobState", "JobStatus", "ScheduleMetrics",
    "UtilizationLog", "compute_metrics", "ElasticClusterController",
    "PlacementError", "PlacementMap", "Actions", "ElasticPolicy",
    "PolicyConfig", "Simulator", "SimWorkload", "VARIANTS", "jacobi_workload",
    "make_jacobi_jobs", "run_variant",
]
