"""Open-loop trace replay: compile a :class:`Trace` into the simulators'
``(JobSpec, SimWorkload)`` streams and drive them.

Copy of ``repro.workloads.replay`` (framework-free), line for line, so both
packages give bit-equal results on the same inputs.

Open-loop means arrivals come from the trace's ``submit_time`` stamps, never
from scheduler feedback — a slow policy faces the same burst a fast one does
(closed-loop replay hides queueing collapse; cf. the workload-replay
literature and Zojer et al.).

Compilation turns one observed point — "this job ran ``duration`` seconds at
``slots`` replicas" — into the elastic description the paper's scheduler
needs:

- ``min/max_replicas`` bracket the natural size by an ``elasticity`` factor;
- the scaling model is Amdahl-shaped around the natural size, normalized so
  ``time_per_step(natural) == 1 s`` and ``total_work == duration`` steps —
  i.e. replay at the natural size reproduces the observed runtime exactly,
  while shrinks/expands pay/gain per the serial fraction;
- ``data_bytes`` (checkpoint footprint for the rescale-overhead model)
  scales with the natural size.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.cloud.node_autoscaler import NodeAutoscaler
from repro_torch.cloud.provider import CloudProvider
from repro_torch.cloud.sim import CloudSimulator
from repro_torch.core.job import JobSpec
from repro_torch.core.metrics import ScheduleMetrics
from repro_torch.core.perf_model import RescaleModel
from repro_torch.core.policies import PolicyConfig
from repro_torch.core.simulator import SimWorkload, Simulator, variant_setup
from repro_torch.workloads.trace import Trace, TraceJob

#: replay variants = the paper's four schedulers + the preempting extension
#: + "rigid": non-malleable replay at each job's OBSERVED request size (what
#: a conventional batch scheduler would have run for this trace)
REPLAY_VARIANTS = ("rigid", "rigid_min", "rigid_max", "moldable", "elastic",
                   "elastic_preempt")


@dataclass(frozen=True)
class TraceScalingModel:
    """Amdahl strong scaling anchored at the trace's observed point:
    ``t(r) = step_seconds * (serial + (1-serial) * natural/r)`` so that
    ``t(natural) == step_seconds`` exactly."""
    natural: int
    serial_fraction: float = 0.05
    step_seconds: float = 1.0

    def time_per_step(self, replicas: int) -> float:
        p = max(1, replicas)
        a = self.serial_fraction
        return self.step_seconds * (a + (1.0 - a) * self.natural / p)

    def rate(self, replicas: int) -> float:
        return 1.0 / self.time_per_step(replicas)


@dataclass(frozen=True)
class ReplayConfig:
    cluster_slots: int              # reference scale the trace was rescaled to
    elasticity: float = 2.0         # min = natural/e, max = natural*e
    serial_fraction: float = 0.05   # Amdahl serial share
    bytes_per_slot: float = 2.0e8   # checkpoint footprint per natural slot
    rescale_gap: float = 180.0      # T_rescale_gap for elastic variants
    fast_lane: bool = True          # checkpoint/reshard fast-lane cost model

    def __post_init__(self):
        assert self.cluster_slots >= 1
        assert self.elasticity >= 1.0
        assert 0.0 <= self.serial_fraction < 1.0


def compile_job(tj: TraceJob, cfg: ReplayConfig
                ) -> Tuple[JobSpec, SimWorkload]:
    natural = min(max(1, tj.slots), cfg.cluster_slots)
    min_r = max(1, int(natural / cfg.elasticity))
    max_r = min(cfg.cluster_slots,
                max(natural, math.ceil(natural * cfg.elasticity)))
    spec = JobSpec(
        job_id=tj.job_id, priority=tj.priority, min_replicas=min_r,
        max_replicas=max_r, submit_time=tj.submit_time, workload=tj)
    wl = SimWorkload(
        scaling=TraceScalingModel(natural, cfg.serial_fraction),
        total_work=tj.duration,                 # steps of 1 s at natural size
        data_bytes=natural * cfg.bytes_per_slot,
        rescale=RescaleModel(fast_lane=cfg.fast_lane))
    return spec, wl


def compile_trace(trace: Trace, cfg: ReplayConfig
                  ) -> List[Tuple[JobSpec, SimWorkload]]:
    return [compile_job(tj, cfg) for tj in trace.jobs]


def _prepare(variant: str, specs: List[JobSpec], cfg: ReplayConfig):
    """Specs transform + policy for one scheduler variant.  The paper's
    variants delegate to :func:`core.simulator.variant_setup` (one source of
    truth); only the trace-specific ``rigid`` baseline lives here."""
    if variant == "rigid":
        # trace-faithful static baseline: exactly the observed request
        # (spec.workload carries the TraceJob compile_job attached)
        specs = [s.rigid(min(max(1, s.workload.slots), cfg.cluster_slots))
                 for s in specs]
        return specs, PolicyConfig(rescale_gap=cfg.rescale_gap), None
    return variant_setup(variant, specs, rescale_gap=cfg.rescale_gap)


def replay_variant(trace: Trace, variant: str, cfg: ReplayConfig,
                   *, slots_per_node: Optional[int] = None, tracer=None,
                   profiler=None, util_series: bool = True,
                   track_phases: bool = True) -> ScheduleMetrics:
    """Replay through the fixed-capacity :class:`Simulator` (the paper's
    §4.3 frame) at ``cfg.cluster_slots`` slots.  ``util_series=False`` /
    ``track_phases=False`` select the simulator's bounded-memory fleet mode
    (O(1) utilization accumulators, no per-job phase ledger) — what the
    ~1M-job bench_simcore replay runs in."""
    pairs = compile_trace(trace, cfg)
    wls: Dict[str, SimWorkload] = {s.job_id: w for s, w in pairs}
    specs, pcfg, policy = _prepare(variant, [s for s, _ in pairs], cfg)
    sim = Simulator(cfg.cluster_slots, pcfg, slots_per_node=slots_per_node,
                    tracer=tracer, profiler=profiler,
                    util_series=util_series, track_phases=track_phases)
    if policy is not None:
        sim.policy = policy
    for s in specs:
        sim.submit(s, wls[s.job_id])
    return sim.run()


def replay_cloud(trace: Trace, cfg: ReplayConfig, provider: CloudProvider,
                 *, variant: str = "elastic",
                 autoscaler: Optional[NodeAutoscaler] = None,
                 placement: str = "pack",
                 pre_run: Optional[Callable[[CloudSimulator], None]] = None,
                 tracer=None, profiler=None) -> CloudSimulator:
    """Replay through :class:`CloudSimulator` (dynamic capacity, spot kills,
    dollars).  Returns the finished simulator — ``.run()`` has been called —
    so callers can read both the metrics and the cost report / kill blasts.
    ``pre_run`` is invoked on the constructed simulator after all arrivals
    are queued and before ``run()`` — the hook deterministic scenarios use
    to inject events (e.g. ``provider.inject_zone_reclaim(..., sim.queue)``
    for the escalating-reclaim bidding benchmark).
    """
    pairs = compile_trace(trace, cfg)
    wls: Dict[str, SimWorkload] = {s.job_id: w for s, w in pairs}
    specs, pcfg, policy = _prepare(variant, [s for s, _ in pairs], cfg)
    sim = CloudSimulator(provider, pcfg, autoscaler=autoscaler,
                         policy=policy, placement=placement, tracer=tracer,
                         profiler=profiler)
    for s in specs:
        sim.submit(s, wls[s.job_id])
    if pre_run is not None:
        pre_run(sim)
    sim.metrics = sim.run()
    return sim
