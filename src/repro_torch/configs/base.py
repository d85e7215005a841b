"""Model configuration for the port (copy of the dense fields of
``repro.configs.base.ModelConfig``).

Only what the dense GQA + SwiGLU path reads is kept; later slices add the
MoE/MLA/SSM/encoder fields with the model families that read them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

FF_SWIGLU = "swiglu"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 => d_model // num_heads
    ff_kind: str = FF_SWIGLU
    vocab_pad_to: int = 256
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    expected_params: float = 0.0
    source: str = ""

    @property
    def padded_vocab(self) -> int:
        p = max(1, self.vocab_pad_to)
        return -(-self.vocab_size // p) * p

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    def scan_layers(self) -> Tuple[int, int]:
        """(num_prefix_layers, num_stacked_layers); dense models stack all."""
        return 0, self.num_layers

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY = {}


def register(arch_id: str):
    def deco(fn):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_config(arch: str) -> ModelConfig:
    from repro_torch import configs  # noqa: F401  (populate registry)
    key = arch if arch in _REGISTRY else arch.lower().replace("_", "-")
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[key]()

