"""Model configuration for the port (copy of the dense and SSM fields of
``repro.configs.base.ModelConfig``).

Only what the dense GQA + SwiGLU path and the Mamba-2 SSD path read is kept;
later slices add the MoE/MLA/encoder fields with the model families that read
them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Layer mixer kinds.
ATTN = "attn"          # softmax attention (GQA / MHA)
SSM = "ssm"            # Mamba-2 SSD block

# Feed-forward kinds.
FF_SWIGLU = "swiglu"   # gated SiLU (llama family)
FF_NONE = "none"       # no FFN in this layer (mamba2 blocks)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128              # N
    head_dim: int = 64              # P
    num_heads: int = 0              # H; 0 => d_inner // head_dim
    expand: int = 2                 # d_inner = expand * d_model
    num_groups: int = 1             # G (B/C groups, GQA-analog)
    conv_width: int = 4
    chunk: int = 128                # SSD chunk length


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
    # layer i uses ATTN iff default_mixer is ATTN, or
    # attn_every and i % attn_every == attn_offset
    default_mixer: str = ATTN
    attn_every: int = 1
    attn_offset: int = 0
    ff_kind: str = FF_SWIGLU
    ssm: Optional[SSMConfig] = None
    vocab_pad_to: int = 256
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    expected_params: float = 0.0
    source: str = ""
    supports_long_context: bool = False

    @property
    def padded_vocab(self) -> int:
        p = max(1, self.vocab_pad_to)
        return -(-self.vocab_size // p) * p

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    def mixer_at(self, i: int) -> str:
        if self.default_mixer == ATTN:
            return ATTN
        # attn_every == 0 encodes "no attention layers at all" (pure SSM)
        if self.attn_every and i % self.attn_every == self.attn_offset:
            return ATTN
        return self.default_mixer

    def ff_at(self, i: int) -> str:
        return self.ff_kind

    def layer_period(self) -> int:
        """Smallest k such that layers i and i+k are structurally identical."""
        if self.default_mixer != ATTN and self.attn_every > 1:
            return self.attn_every
        return 1

    def scan_layers(self) -> Tuple[int, int]:
        """(num_prefix_layers, num_stacked_layers); a tail that is not a
        multiple of the period goes to the prefix."""
        prefix = self.num_layers % self.layer_period()
        return prefix, self.num_layers - prefix

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
