"""Workload subsystem: trace ingestion, synthetic generators, characterization
stats, and open-loop replay through the simulators (see README §Workloads).

Copy of ``repro.workloads`` (framework-free), line for line, so both
packages give bit-equal results on the same inputs.
"""
from repro_torch.workloads.replay import (REPLAY_VARIANTS, ReplayConfig,
                                          TraceScalingModel, compile_job,
                                          compile_trace, replay_cloud,
                                          replay_variant)
from repro_torch.workloads.stats import (WorkloadStats, characterize,
                                         hill_tail_index)
from repro_torch.workloads.synthetic import (GENERATORS, bursty_trace,
                                             diurnal_trace, generate,
                                             google_fleet_trace, heavy_tail_trace,
                                             poisson_trace, uniform_trace)
from repro_torch.workloads.trace import (HIGH_PRIORITY, LOW_PRIORITY, LOADERS,
                                         Trace, TraceJob, fixture_path,
                                         load_azure_trace, load_google_trace)

__all__ = [
    "REPLAY_VARIANTS", "ReplayConfig", "TraceScalingModel", "compile_job",
    "compile_trace", "replay_cloud", "replay_variant",
    "WorkloadStats", "characterize", "hill_tail_index",
    "GENERATORS", "bursty_trace", "diurnal_trace", "generate",
    "google_fleet_trace", "heavy_tail_trace", "poisson_trace",
    "uniform_trace",
    "HIGH_PRIORITY", "LOW_PRIORITY", "LOADERS", "Trace", "TraceJob",
    "fixture_path", "load_azure_trace", "load_google_trace",
]
