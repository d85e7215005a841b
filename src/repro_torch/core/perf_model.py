"""Performance models consumed by the simulator (paper C3).

Copy of ``repro.core.perf_model``, except :class:`ArchScalingModel`, whose
device constants are the NVIDIA H100's instead of the reference's.

The paper models (a) job runtime vs. replicas via piecewise-linear
interpolation of measured strong-scaling points and (b) rescale overhead via
piecewise-linear interpolation of measured stage times.  We provide:

- :class:`PiecewiseScalingModel` — exactly that interpolation, given points;
- :class:`JacobiModel` — analytic Jacobi2D strong-scaling generator (compute
  n^2/p, halo n/sqrt(p), latency) used to synthesize the measurement points we
  cannot take on EKS, calibrated to the paper's Table 1 magnitudes;
- :class:`RescaleModel` — the four-stage overhead (checkpoint/restart/restore/
  load-balance) with the paper's observed asymptotics (Fig. 5): restart grows
  with replica count, checkpoint/restore scale with per-replica bytes,
  load-balance is flat in replicas and grows with problem size;
- :class:`ArchScalingModel` — step time of one of *this framework's* training
  jobs vs. number of 8-GPU replica groups, from 6*N*D FLOPs over the H100's
  peak and the gradient all-reduce over NVLink (ties C3 to the GPU substrate).

The Jacobi and rescale constants below are copied unchanged: they model the
paper's EKS vCPU cluster and the reference's CPU-measured checkpoint fast
lane, not any accelerator, and none of them is a number of the H100.  They
stay equal to the reference's so Table 1, Fig. 7 and Fig. 8 come out the
same in both packages.
"""
from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple


def interp_piecewise(points: Sequence[Tuple[float, float]], x: float) -> float:
    """Piecewise-linear interpolation with flat extrapolation."""
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    if x <= xs[0]:
        return ys[0]
    if x >= xs[-1]:
        return ys[-1]
    i = bisect.bisect_right(xs, x)
    x0, x1, y0, y1 = xs[i - 1], xs[i], ys[i - 1], ys[i]
    return y0 + (y1 - y0) * (x - x0) / (x1 - x0)


@dataclass(frozen=True)
class PiecewiseScalingModel:
    """time-per-work-unit as piecewise-linear in replica count."""
    points: Tuple[Tuple[float, float], ...]   # (replicas, seconds/unit)

    def time_per_unit(self, replicas: int) -> float:
        # replica counts are small ints and the model is frozen, so every
        # lookup after the first is a dict hit (this sits under every
        # completion-time estimate the simulator makes)
        try:
            memo = self._memo
        except AttributeError:
            memo = {}
            object.__setattr__(self, "_memo", memo)
        y = memo.get(replicas)
        if y is None:
            xs = [p[0] for p in self.points]
            ys = [p[1] for p in self.points]
            x = float(replicas)
            if x <= xs[0]:
                y = ys[0]
            elif x >= xs[-1]:
                y = ys[-1]
            else:
                i = bisect.bisect_right(xs, x)
                x0, x1, y0, y1 = xs[i - 1], xs[i], ys[i - 1], ys[i]
                y = y0 + (y1 - y0) * (x - x0) / (x1 - x0)
            memo[replicas] = y
        return y

    # simulator-facing alias: one work unit == one step
    def time_per_step(self, replicas: int) -> float:
        return self.time_per_unit(replicas)

    def rate(self, replicas: int) -> float:
        return 1.0 / self.time_per_unit(replicas)


# ---------------------------------------------------------------------------
# Jacobi2D (the paper's workload)
# ---------------------------------------------------------------------------

# calibration constants (the paper's EKS vCPU cluster, not a GPU): chosen
# so the Table 1 experiment
# (64 slots, 16 jobs, 90 s submission gap) lands in the paper's magnitude
# range (makespans ~1800-2500 s).
FLOP_PER_POINT = 5.0
EFF_FLOPS_PER_REPLICA = 1.0e9      # effective stencil rate per vCPU-replica
HALO_BYTES_PER_POINT = 16.0
NET_BW = 1.0e8                     # bytes/s per replica pair (EKS TCP-ish)
NET_LAT = 5.0e-4


@dataclass(frozen=True)
class JacobiModel:
    grid_n: int
    timesteps: int

    def time_per_step(self, replicas: int) -> float:
        p = max(1, replicas)
        n = self.grid_n
        compute = FLOP_PER_POINT * n * n / p / EFF_FLOPS_PER_REPLICA
        halo = HALO_BYTES_PER_POINT * n / math.sqrt(p) / NET_BW
        return compute + halo + NET_LAT

    def scaling_model(self, replica_grid: Sequence[int]
                      ) -> PiecewiseScalingModel:
        """Synthesize the 'measured' strong-scaling points the paper would
        have interpolated (Fig. 4a)."""
        return PiecewiseScalingModel(tuple(
            (float(r), self.time_per_step(r)) for r in replica_grid))

    @property
    def data_bytes(self) -> float:
        return 2 * 4.0 * self.grid_n * self.grid_n   # two fp32 grids


# the paper's four simulated job sizes (§4.3.1)
JACOBI_SIZES: Dict[str, dict] = {
    "small": dict(grid_n=512, timesteps=40_000, min_replicas=2, max_replicas=8),
    "medium": dict(grid_n=2048, timesteps=40_000, min_replicas=4, max_replicas=16),
    "large": dict(grid_n=8192, timesteps=40_000, min_replicas=8, max_replicas=32),
    "xlarge": dict(grid_n=16_384, timesteps=10_000, min_replicas=16, max_replicas=64),
}


# ---------------------------------------------------------------------------
# Rescale overhead (paper Fig. 5 asymptotics)
# ---------------------------------------------------------------------------

RESTART_BASE = 1.0                 # process-group restart floor
RESTART_PER_REPLICA = 0.08         # MPI startup grows with ranks
CKPT_BW_PER_REPLICA = 2.0e9        # /dev/shm write bandwidth per replica
RESTORE_BW_PER_REPLICA = 3.0e9
LB_BASE = 0.3
LB_PER_BYTE = 5.0e-11              # object migration grows with problem size
DISK_BW_PER_REPLICA = 2.0e8        # preemption checkpoints go to DISK (§3.2.2)

# -- fast lane ---------------------------------------------------------------
# The reference's constants, grounded by its slow-lane `fig5.live.*` /
# `fig5.kernel.*` rows (the JAX package's benchmarks/fig5_rescale_overhead.py,
# measured there on the CPU, not on a GPU): P2P reshard is one device_put with
# no host round-trip, warm restart is a mesh-cache hit instead of a re-jit,
# load-balance is the measured microseconds-scale shard_bounds re-split,
# preempt overlaps the write (async submit + barrier) and only rewrites the
# hot fraction of the tree (delta manifest), resume pipelines the restart
# with the disk read.
P2P_RESHARD_BW_PER_REPLICA = 2.5e10   # device-to-device, no host bounce
RESTART_WARM_BASE = 0.15              # cached-mesh restart floor
RESTART_WARM_PER_REPLICA = 0.01
LB_FAST_BASE = 0.02                   # stream re-split, no object migration
LB_FAST_PER_BYTE = 5.0e-12
ASYNC_BARRIER_S = 0.05                # join of the in-flight background write
DELTA_CKPT_FRACTION = 0.35            # hot-leaf share of the tree (measured)


@dataclass(frozen=True)
class RescaleModel:
    """Four-stage rescale overhead; ``stages`` returns the Fig. 5 breakdown.

    ``fast_lane=True`` (the default) prices the checkpoint/reshard fast
    path: P2P device-to-device reshard (no host snapshot), warm restarts
    from the mesh cache, async+delta disk checkpoints at preempt time.
    ``RescaleModel(fast_lane=False)`` reproduces the legacy (paper-faithful
    synchronous) cost model exactly.
    """
    fast_lane: bool = True

    def stages(self, old_replicas: int, new_replicas: int,
               data_bytes: float) -> Dict[str, float]:
        if self.fast_lane:
            return {
                "load_balance": LB_FAST_BASE + LB_FAST_PER_BYTE * data_bytes,
                # P2P reshard: no host snapshot; the move is billed as
                # restore (one device_put off the old shards)
                "checkpoint": 0.0,
                "restart": (RESTART_WARM_BASE
                            + RESTART_WARM_PER_REPLICA * new_replicas),
                "restore": data_bytes / (P2P_RESHARD_BW_PER_REPLICA
                                         * max(1, old_replicas)),
            }
        return {
            # shrink load-balances before ckpt/restart, expand after (§2.2) —
            # cost model identical either way
            "load_balance": LB_BASE + LB_PER_BYTE * data_bytes,
            "checkpoint": data_bytes / (CKPT_BW_PER_REPLICA * old_replicas),
            "restart": RESTART_BASE + RESTART_PER_REPLICA * new_replicas,
            "restore": data_bytes / (RESTORE_BW_PER_REPLICA * new_replicas),
        }

    def total(self, old_replicas: int, new_replicas: int,
              data_bytes: float) -> float:
        return sum(self.stages(old_replicas, new_replicas, data_bytes).values())

    def preempt_cost(self, replicas: int, data_bytes: float) -> float:
        """Checkpoint-to-disk on preemption (paper §3.2.2).

        Fast lane: the write already started in the background (async
        submit); preempt pays the barrier plus the unwritten hot fraction
        (delta manifest skips cold leaves)."""
        full = data_bytes / (DISK_BW_PER_REPLICA * max(1, replicas))
        if self.fast_lane:
            return ASYNC_BARRIER_S + DELTA_CKPT_FRACTION * full
        return full

    def resume_cost(self, replicas: int, data_bytes: float) -> float:
        """Restart + restore-from-disk when a preempted job resumes.

        Fast lane: warm restart pipelined with the disk read (the read
        dominates for real payloads), so the two overlap instead of adding.
        """
        read = data_bytes / (DISK_BW_PER_REPLICA * max(1, replicas))
        if self.fast_lane:
            return max(RESTART_WARM_BASE + RESTART_WARM_PER_REPLICA * replicas,
                       read)
        return RESTART_BASE + RESTART_PER_REPLICA * replicas + read


# ---------------------------------------------------------------------------
# GPU training jobs (ties the scheduler to this framework's archs)
# ---------------------------------------------------------------------------

# NVIDIA H100 80GB HBM3, 700 W (NVIDIA's data sheet, SXM part, dense rates;
# the same constants chip_smoke.py bounds the kernels with)
H100_PEAK_FLOPS_BF16 = 989e12      # NVIDIA H100 80GB HBM3, 700 W: bf16 tensor cores
H100_PEAK_FLOPS_FP32 = 67e12       # NVIDIA H100 80GB HBM3, 700 W: fp32, no tensor cores
H100_HBM_BW = 3.35e12              # NVIDIA H100 80GB HBM3, 700 W: HBM3 bytes/s
H100_NVLINK_BW = 450e9             # NVIDIA H100 80GB HBM3, 700 W: NVLink bytes/s per direction
# a modelling choice, not a property of the card: one replica group is the 8
# GPUs of one HGX node, one NVLink domain
GPUS_PER_REPLICA = 8


@dataclass(frozen=True)
class ArchScalingModel:
    """Step time vs. replica-group count for a data-parallel training job.

    flops_per_step: model FLOPs of the global batch's forward and backward
    (strong scaling: global batch fixed), analytically 6*N*D.  peak_flops:
    the H100's rate for the job's dtype (bf16 by default,
    :data:`H100_PEAK_FLOPS_FP32` for an fp32 job).  mfu: sustained fraction
    of that peak, a modelling assumption.  gpus_per_group: GPUs of one
    replica group (1 predicts a single card).
    """
    name: str
    flops_per_step: float          # global-batch fwd+bwd FLOPs
    param_bytes: float             # gradient all-reduce payload
    mfu: float = 0.4
    peak_flops: float = H100_PEAK_FLOPS_BF16
    gpus_per_group: int = GPUS_PER_REPLICA

    def time_per_step(self, groups: int) -> float:
        compute = self.flops_per_step / (
            groups * self.gpus_per_group * self.peak_flops * self.mfu)
        # data-parallel gradient ring all-reduce across groups
        if groups > 1:
            comm = 2 * self.param_bytes * (groups - 1) / groups / (
                self.gpus_per_group * H100_NVLINK_BW)
        else:
            comm = 0.0
        return compute + max(comm, 0.0)

    @property
    def data_bytes(self) -> float:
        # checkpoint payload: params + fp32 adam moments
        return self.param_bytes * (1 + 4)


def arch_model_from_config(cfg, seq_len: int = 4096,
                           global_batch: int = 256) -> ArchScalingModel:
    """FLOPs from the ACTIVE parameters (an MoE token runs only its top-k
    experts); the all-reduce and checkpoint bytes from all of them."""
    from repro_torch.configs.base import count_active_params, count_params
    n_active = count_active_params(cfg)
    n_total = count_params(cfg)
    tokens = seq_len * global_batch
    return ArchScalingModel(
        name=cfg.name,
        flops_per_step=6.0 * n_active * tokens,
        param_bytes=2.0 * n_total,
    )
