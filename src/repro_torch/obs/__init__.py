"""Flight recorder of the port's scheduler (observability layer).

- :mod:`repro_torch.obs.trace`     structured JSONL span/event records + null
  tracer
- :mod:`repro_torch.obs.decisions` decision-audit records (inputs,
  alternatives, verdict) at the policies' choice points
- :mod:`repro_torch.obs.stats`     streaming P2 quantiles, counters, latency
  recorder
- :mod:`repro_torch.obs.audit`     trace replayer re-deriving conservation
  invariants
- :mod:`repro_torch.obs.timeline`  text Gantt renderer over a trace
- :mod:`repro_torch.obs.spans`     causal span graph (lifecycle trees + cause
  edges)
- :mod:`repro_torch.obs.critical_path` per-job phase decomposition + fleet
  rollups
- :mod:`repro_torch.obs.profile`   zero-dep self-profiler for the simulator
  hot path
- :mod:`repro_torch.obs.watchdog`  perf baseline diff + metric-stream anomaly
  scan

Copies of the JAX package's modules of the same names (framework-free).
The simulator and the live operator of both packages emit the same records,
so either package's auditor reads either's traces.
"""
from repro_torch.obs.critical_path import (PHASES, FleetPhases, PhaseLedger,
                                           decompose, rollup)
from repro_torch.obs.decisions import DecisionLog, decision_records
from repro_torch.obs.profile import (SimProfiler, current_profiler,
                                     install_profiler)
from repro_torch.obs.spans import (Span, SpanGraph, SpanGraphBuilder, SpanTap,
                                   build_span_graph)
from repro_torch.obs.stats import Counters, LatencyRecorder, P2Quantile
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, Tracer,
                                   current_tracer, install)
from repro_torch.obs.watchdog import (WatchdogConfig, WatchdogReport,
                                      diff_snapshots, rolling_median_spikes)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "install", "current_tracer",
    "DecisionLog", "decision_records",
    "P2Quantile", "Counters", "LatencyRecorder",
    "Span", "SpanGraph", "SpanGraphBuilder", "SpanTap", "build_span_graph",
    "PHASES", "PhaseLedger", "FleetPhases", "decompose", "rollup",
    "SimProfiler", "current_profiler", "install_profiler",
    "WatchdogConfig", "WatchdogReport", "diff_snapshots",
    "rolling_median_spikes",
]
