"""Roofline terms from dry-run analyses, with one NVIDIA H100's constants
(counterpart of ``repro.utils.roofline``, whose defaults are a TPU v5e's).

Terms (per training or serving step, seconds):
    compute    = FLOPs_per_device / peak_FLOP/s
    memory     = HBM_bytes_per_device / HBM_bw
    collective = collective_bytes_per_device / link_bw

There is one peak, as in the reference: the bf16 tensor-core rate.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core.perf_model import (H100_HBM_BW, H100_NVLINK_BW,
                                         H100_PEAK_FLOPS_BF16)


@dataclass(frozen=True)
class HW:
    peak_flops: float = H100_PEAK_FLOPS_BF16    # NVIDIA H100 80GB HBM3, 700 W: bf16
    hbm_bw: float = H100_HBM_BW                 # NVIDIA H100 80GB HBM3, 700 W: bytes/s
    ici_bw: float = H100_NVLINK_BW              # NVIDIA H100 80GB HBM3, 700 W: NVLink bytes/s
    hbm_bytes: float = 80e9                     # NVIDIA H100 80GB HBM3: capacity


H100 = HW(peak_flops=H100_PEAK_FLOPS_BF16, hbm_bw=H100_HBM_BW,
          ici_bw=H100_NVLINK_BW, hbm_bytes=80e9)


@dataclass
class RooflineTerms:
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    model_flops_global: float        # 6*N*D (or 6*N_active*D for MoE)
    chips: int
    hw: HW = field(default_factory=lambda: H100)

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_device / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / self.hw.ici_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        """Perfect-overlap bound: max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs: the remat/padding/dispatch waste."""
        hlo_global = self.flops_per_device * self.chips
        return self.model_flops_global / hlo_global if hlo_global else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization achievable at the roofline bound."""
        t = self.step_time_lower_bound
        if t <= 0:
            return 0.0
        return self.model_flops_global / (self.chips * self.hw.peak_flops * t)

    def as_dict(self) -> Dict[str, float]:
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "model_flops_global": self.model_flops_global,
            "chips": self.chips,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_fraction": self.useful_flops_fraction,
            "mfu_bound": self.mfu_bound,
            "step_time_lower_bound": self.step_time_lower_bound,
        }


def roofline_from_analysis(cost: Optional[dict], collective_bytes_per_device: float,
                           model_flops_global: float, chips: int,
                           hw: HW = H100) -> RooflineTerms:
    """``cost``: a {'flops', 'bytes accessed'} dict (per device), or None."""
    cost = cost or {}
    return RooflineTerms(
        flops_per_device=float(cost.get("flops", 0.0)),
        hbm_bytes_per_device=float(cost.get("bytes accessed", 0.0)),
        collective_bytes_per_device=collective_bytes_per_device,
        model_flops_global=model_flops_global,
        chips=chips, hw=hw)


__all__ = ["HW", "H100", "RooflineTerms", "roofline_from_analysis"]
