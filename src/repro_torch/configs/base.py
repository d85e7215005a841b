"""Model configuration for the port (copy of ``repro.configs.base``'s
``ModelConfig``, its sub-configs, the registry and the analytic parameter
counts), and of its input shapes (``ShapeConfig``, ``SHAPES``,
``shape_applicable``).

Every field of the reference's ``ModelConfig`` is here, so ``count_params``
is a line-for-line copy; the model refuses the layouts whose family is not
ported yet (``models/params.py``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

# Layer mixer kinds.
ATTN = "attn"          # softmax attention (GQA / MHA)
MLA = "mla"            # multi-head latent attention (DeepSeek-V2)
SSM = "ssm"            # Mamba-2 SSD block

# Feed-forward kinds.
FF_SWIGLU = "swiglu"   # gated SiLU (llama family)
FF_GELU = "gelu"       # plain 2-matrix GELU MLP (starcoder2)
FF_RELU2 = "relu2"     # squared-ReLU non-gated (nemotron/minitron)
FF_MOE = "moe"         # mixture-of-experts (uses moe_* fields)
FF_NONE = "none"       # no FFN in this layer (mamba2 blocks)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # routed experts
    experts_per_token: int = 0      # top-k
    num_shared_experts: int = 0     # always-on shared experts (DeepSeek-V2)
    d_ff_expert: int = 0            # per-expert hidden dim
    # which layers are MoE: layer i is MoE iff i % moe_every == moe_offset
    # and i >= first_dense (DeepSeek first_k_dense_replace).
    moe_every: int = 1
    moe_offset: int = 0
    first_dense: int = 0
    router_aux_weight: float = 0.01  # load-balancing loss weight
    ff_kind: str = FF_SWIGLU         # activation inside each expert
    capacity_factor: float = 1.25    # per-expert token capacity multiplier


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 0            # 0 => full-rank q projection
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


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
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                       # dense-FFN hidden dim (0 if no dense FFN)
    vocab_size: int
    head_dim: int = 0               # 0 => d_model // num_heads

    # Mixer layout: default every layer is `default_mixer`; hybrids override
    # with attn_every/attn_offset (layer i uses ATTN iff i % attn_every == attn_offset).
    default_mixer: str = ATTN
    attn_every: int = 1
    attn_offset: int = 0

    ff_kind: str = FF_SWIGLU
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # enc-dec (seamless): if enc_layers > 0 the model is encoder-decoder and
    # `num_layers` counts decoder layers.
    enc_layers: int = 0

    # Modality frontend stub: "none" (token ids), "audio" or "vision"
    # (precomputed frame/patch embeddings are an alternative input).
    frontend: str = "none"

    # embedding/lm-head tables are padded up to a multiple of this so the
    # vocab dim shards evenly (MaxText-style); logits beyond vocab_size are
    # masked in the loss and sliced off in serving.
    vocab_pad_to: int = 256
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    qk_norm: bool = False           # chameleon-style per-head q/k RMSNorm
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # expected parameter count (for sanity tests); 0 to skip the check.
    expected_params: float = 0.0
    # paper-source provenance string.
    source: str = ""
    # archs that may run the long_500k shape (sub-quadratic mixing).
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
            return ATTN if self.mla is None else MLA
        # attn_every == 0 encodes "no attention layers at all" (pure SSM).
        if self.attn_every and i % self.attn_every == self.attn_offset:
            return ATTN
        return self.default_mixer

    def ff_at(self, i: int) -> str:
        m = self.moe
        if m is not None and m.num_experts > 0:
            if i >= m.first_dense and i % m.moe_every == m.moe_offset:
                return FF_MOE
        return self.ff_kind

    def layer_period(self) -> int:
        """Smallest k such that layers i and i+k are structurally identical."""
        period = 1
        if self.default_mixer != ATTN and self.attn_every > 1:
            period = self.attn_every
        if self.moe is not None and self.moe.num_experts > 0:
            period = _lcm(period, self.moe.moe_every)
        return period

    def scan_layers(self) -> Tuple[int, int]:
        """(num_prefix_layers, num_stacked_layers): the first_dense layers,
        and a tail that is not a multiple of the period, go to the prefix."""
        prefix = 0
        if self.moe is not None and self.moe.first_dense > 0:
            prefix = self.moe.first_dense
        period = self.layer_period()
        rem = (self.num_layers - prefix) % period
        prefix += rem
        return prefix, self.num_layers - prefix

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell, with a reason when not."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch: O(L^2) attention at 524k skipped per assignment"
    return True, ""


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


def list_archs():
    from repro_torch import configs  # noqa: F401
    return sorted(_REGISTRY)


def count_params(cfg: ModelConfig) -> int:
    """Closed-form parameter count; equals ``models.params.param_count`` for
    every layout the port builds."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    total = cfg.padded_vocab * d  # embed
    if not cfg.tie_embeddings:
        total += cfg.padded_vocab * d  # lm head
    total += d  # final norm

    def ff_params(kind: str) -> int:
        if kind == FF_SWIGLU:
            return 3 * d * cfg.d_ff
        if kind in (FF_GELU, FF_RELU2):
            return 2 * d * cfg.d_ff
        if kind == FF_NONE:
            return 0
        raise ValueError(kind)

    def moe_params() -> int:
        m = cfg.moe
        per_expert = 3 * d * m.d_ff_expert if m.ff_kind == FF_SWIGLU else 2 * d * m.d_ff_expert
        total_m = m.num_experts * per_expert + m.num_shared_experts * per_expert
        total_m += d * m.num_experts  # router
        return total_m

    def attn_params() -> int:
        q = d * cfg.num_heads * hd
        kv = 2 * d * cfg.num_kv_heads * hd
        o = cfg.num_heads * hd * d
        return q + kv + o

    def mla_params() -> int:
        a = cfg.mla
        nh = cfg.num_heads
        p = 0
        if a.q_lora_rank:
            p += d * a.q_lora_rank + a.q_lora_rank  # down + norm
            p += a.q_lora_rank * nh * (a.qk_nope_head_dim + a.qk_rope_head_dim)
        else:
            p += d * nh * (a.qk_nope_head_dim + a.qk_rope_head_dim)
        p += d * (a.kv_lora_rank + a.qk_rope_head_dim)  # kv down (+ shared rope key)
        p += a.kv_lora_rank  # kv norm
        p += a.kv_lora_rank * nh * (a.qk_nope_head_dim + a.v_head_dim)  # kv up
        p += nh * a.v_head_dim * d  # o proj
        return p

    def ssm_params() -> int:
        s = cfg.ssm
        d_inner = s.expand * d
        nh = s.num_heads or d_inner // s.head_dim
        conv_dim = d_inner + 2 * s.num_groups * s.d_state
        p = d * (2 * d_inner + 2 * s.num_groups * s.d_state + nh)  # in_proj (z,x,B,C,dt)
        p += s.conv_width * conv_dim + conv_dim  # conv weight + bias
        p += nh * 3  # A_log, D, dt_bias
        p += d_inner  # pre-out norm
        p += d_inner * d  # out_proj
        return p

    def layer_params(i: int) -> int:
        mixer = cfg.mixer_at(i)
        p = d  # pre-mixer norm
        if mixer == ATTN:
            p += attn_params()
            if cfg.qk_norm:
                p += 2 * hd
        elif mixer == MLA:
            p += mla_params()
        elif mixer == SSM:
            p += ssm_params()
        ff = cfg.ff_at(i)
        if ff != FF_NONE:
            p += d  # pre-ff norm
            p += moe_params() if ff == FF_MOE else ff_params(ff)
        return p

    for i in range(cfg.num_layers):
        total += layer_params(i)

    if cfg.enc_layers:
        # encoder: self-attn + dense ffn per layer, plus cross-attn params in
        # each decoder layer and a final encoder norm.
        enc_layer = 2 * d + attn_params() + ff_params(cfg.ff_kind)
        total += cfg.enc_layers * enc_layer + d
        total += cfg.num_layers * (d + attn_params())  # decoder cross-attn + norm
    return total


def count_active_params(cfg: ModelConfig) -> int:
    """Active (per-token) params: num_experts replaced with experts_per_token
    (shared experts stay)."""
    if cfg.moe is None or cfg.moe.num_experts == 0:
        return count_params(cfg)
    active_moe = dataclasses.replace(
        cfg.moe, num_experts=cfg.moe.experts_per_token)
    return count_params(cfg.with_(moe=active_moe))
