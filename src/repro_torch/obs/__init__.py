"""Flight recorder of the port's scheduler (observability layer).

- :mod:`repro_torch.obs.trace`     structured JSONL event records + null tracer
- :mod:`repro_torch.obs.decisions` decision-audit records at the policy's
  choice points
- :mod:`repro_torch.obs.stats`     streaming P2 quantiles, counters, latency
  recorder

Copies of the JAX package's modules of the same names.  Its auditor,
timeline, span graph, critical path, profiler and watchdog read the port's
records unchanged and are not ported yet.
"""
from repro_torch.obs.decisions import DecisionLog, decision_records
from repro_torch.obs.stats import Counters, LatencyRecorder, P2Quantile
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, Tracer,
                                   current_tracer, install)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "install", "current_tracer",
    "DecisionLog", "decision_records",
    "P2Quantile", "Counters", "LatencyRecorder",
]
