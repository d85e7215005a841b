"""Analytic FLOPs and HBM-traffic models per (arch x shape) cell: a copy
of ``repro.utils.flops``, equal to it number for number.

These closed-form models count what the JAX package's implementation
executes (its layer, attention-block, SSD-chunk and loss scans are costed
here because XLA's ``cost_analysis`` counts a loop body once):

- blocked attention computes ALL KV blocks (masked, not skipped): fwd QK^T+AV
  = 4*B*S^2*H*hd, bwd ~2x + one recompute of the score matmul;
- SSD chunk math: per token per head 2*Q*(N+P) intra + ~8*P*N state work;
- MoE gather dispatch computes B*E*capacity token slots (padding included);
- vocab padding and remat recompute are included — so
  MODEL_FLOPS / analytic_total is a real waste metric.

Training total = fwd + 2x bwd + 1x remat recompute (full remat policy)
               + optimizer elementwise (~10 flops/param).
Everything is GLOBAL; divide by chips for per-device.  ``cell_hbm_bytes``
assumes 2-byte weights.
"""
from __future__ import annotations

from repro_torch.configs.base import (ATTN, FF_GELU, FF_MOE, FF_NONE,
                                      FF_RELU2, FF_SWIGLU, MLA, SSM,
                                      ModelConfig, ShapeConfig)


def _ffn_flops_per_tok(cfg, kind: str, d_ff: int) -> float:
    d = cfg.d_model
    return (6.0 if kind == FF_SWIGLU else 4.0) * d * d_ff


def _moe_flops_per_tok(cfg) -> float:
    m, d = cfg.moe, cfg.d_model
    mults = 6.0 if m.ff_kind == FF_SWIGLU else 4.0
    # dispatched token-slots per real token: E * cap / S ~= k * capacity_factor
    # (cap includes padding; mirror cells' cap formula per sequence)
    slots_per_tok = m.experts_per_token * m.capacity_factor
    total = mults * d * m.d_ff_expert * slots_per_tok
    total += 2.0 * d * m.num_experts                       # router
    if m.num_shared_experts:
        total += mults * d * m.num_shared_experts * m.d_ff_expert
    return total


def _attn_proj_flops_per_tok(cfg) -> float:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    return 2.0 * d * hd * (h + 2 * kv) + 2.0 * h * hd * d


def _mla_proj_flops_per_tok(cfg) -> float:
    a, d, h = cfg.mla, cfg.d_model, cfg.num_heads
    qk = a.qk_nope_head_dim + a.qk_rope_head_dim
    f = 2.0 * d * (a.kv_lora_rank + a.qk_rope_head_dim)        # kv down
    if a.q_lora_rank:
        f += 2.0 * d * a.q_lora_rank + 2.0 * a.q_lora_rank * h * qk
    else:
        f += 2.0 * d * h * qk
    # per-token K/V expansion from the latent (train/prefill path)
    f += 2.0 * a.kv_lora_rank * h * (a.qk_nope_head_dim + a.v_head_dim)
    f += 2.0 * h * a.v_head_dim * d                            # o proj
    return f


def _ssm_flops_per_tok(cfg) -> float:
    ss, d = cfg.ssm, cfg.d_model
    di = ss.expand * d
    nh = ss.num_heads or di // ss.head_dim
    gn = ss.num_groups * ss.d_state
    f = 2.0 * d * (2 * di + 2 * gn + nh)                       # in_proj
    f += 2.0 * ss.conv_width * (di + 2 * gn)                   # conv
    # SSD core: intra-chunk 2*Q*(N+P) per head-token + state update ~8*P*N/Q
    Q, N, P = ss.chunk, ss.d_state, ss.head_dim
    f += nh * (2.0 * Q * (N + P) + 8.0 * P * N)
    f += 2.0 * di * d                                          # out proj
    return f


def _attn_ctx_flops(cfg, B: int, Sq: int, Sk: int) -> float:
    """Score+AV matmuls (all blocks computed, masked)."""
    h = cfg.num_heads
    if cfg.mla is not None:
        a = cfg.mla
        return 2.0 * B * Sq * Sk * h * (a.qk_nope_head_dim + a.qk_rope_head_dim) \
            + 2.0 * B * Sq * Sk * h * a.v_head_dim
    hd = cfg.resolved_head_dim
    return 4.0 * B * Sq * Sk * h * hd


def fwd_flops(cfg: ModelConfig, B: int, S: int, enc_len: int = 0) -> float:
    """Global forward FLOPs for a full sequence pass (train/prefill)."""
    tok = float(B) * S
    total = 0.0
    for i in range(cfg.num_layers):
        mixer = cfg.mixer_at(i)
        if mixer == ATTN:
            total += tok * _attn_proj_flops_per_tok(cfg)
            total += _attn_ctx_flops(cfg, B, S, S)
        elif mixer == MLA:
            total += tok * _mla_proj_flops_per_tok(cfg)
            total += _attn_ctx_flops(cfg, B, S, S)
        elif mixer == SSM:
            total += tok * _ssm_flops_per_tok(cfg)
        ff = cfg.ff_at(i)
        if ff == FF_MOE:
            total += tok * _moe_flops_per_tok(cfg)
        elif ff != FF_NONE:
            total += tok * _ffn_flops_per_tok(cfg, ff, cfg.d_ff)
        if cfg.enc_layers:   # cross attention in every decoder layer
            total += tok * _attn_proj_flops_per_tok(cfg)
            total += _attn_ctx_flops(cfg, B, S, enc_len or S)
    if cfg.enc_layers:
        etok = float(B) * (enc_len or S)
        per = (_attn_proj_flops_per_tok(cfg)
               + _ffn_flops_per_tok(cfg, cfg.ff_kind, cfg.d_ff))
        total += cfg.enc_layers * (etok * per
                                   + _attn_ctx_flops(cfg, B, enc_len or S,
                                                     enc_len or S))
    total += 2.0 * tok * cfg.d_model * cfg.padded_vocab       # lm head
    return total


def decode_flops(cfg: ModelConfig, B: int, ctx: int) -> float:
    """One decode step for B sequences against a ctx-long cache."""
    total = 0.0
    for i in range(cfg.num_layers):
        mixer = cfg.mixer_at(i)
        if mixer == ATTN:
            total += B * _attn_proj_flops_per_tok(cfg)
            total += _attn_ctx_flops(cfg, B, 1, ctx)
        elif mixer == MLA:
            a = cfg.mla
            h = cfg.num_heads
            # absorbed path: q_lat + scores/ctx against the latent cache
            total += B * _mla_proj_flops_per_tok(cfg)
            total += 2.0 * B * h * a.qk_nope_head_dim * a.kv_lora_rank
            total += 2.0 * B * ctx * h * (a.kv_lora_rank + a.qk_rope_head_dim)
            total += 2.0 * B * ctx * h * a.kv_lora_rank
        elif mixer == SSM:
            ss = cfg.ssm
            di = ss.expand * cfg.d_model
            nh = ss.num_heads or di // ss.head_dim
            total += B * (_ssm_flops_per_tok(cfg)
                          + 6.0 * nh * ss.head_dim * ss.d_state)
        ff = cfg.ff_at(i)
        if ff == FF_MOE:
            total += B * _moe_flops_per_tok(cfg)
        elif ff != FF_NONE:
            total += B * _ffn_flops_per_tok(cfg, ff, cfg.d_ff)
        if cfg.enc_layers:
            total += B * _attn_proj_flops_per_tok(cfg)
            total += _attn_ctx_flops(cfg, B, 1, ctx)
    total += 2.0 * B * cfg.d_model * cfg.padded_vocab
    return total


# bwd = 2x fwd; full-remat recompute = +1x fwd; optimizer ~10 flops/param
TRAIN_MULT = 4.0


def cell_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    from repro_torch.configs.base import count_params
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return TRAIN_MULT * fwd_flops(cfg, B, S, enc_len=S) \
            + 10.0 * count_params(cfg)
    if shape.kind == "prefill":
        return fwd_flops(cfg, B, S, enc_len=S)
    return decode_flops(cfg, B, S)


# ---------------------------------------------------------------------------
# HBM traffic (global bytes per step) — coarse but explicit
# ---------------------------------------------------------------------------

def cell_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Per-step global HBM traffic:

    train:   params bf16 read 3x (fwd, remat, bwd) + grad write + optimizer
             m/v read+write (fp32) + param rw  ~= 26 bytes/param
             + activation traffic ~= 24 bytes per token per d_model per layer
    prefill: params once + activations fwd + cache write
    decode:  params once + full cache read + tiny activations
    """
    from repro_torch.configs.base import count_params
    P = float(count_params(cfg))
    B, S = shape.global_batch, shape.seq_len
    d, L = cfg.d_model, cfg.num_layers + cfg.enc_layers

    def act_bytes(tokens, mult):
        return mult * tokens * d * L

    def cache_bytes():
        total = 0.0
        for i in range(cfg.num_layers):
            mixer = cfg.mixer_at(i)
            if mixer == ATTN:
                total += 2.0 * B * S * cfg.num_kv_heads * \
                    cfg.resolved_head_dim * 2
            elif mixer == MLA:
                a = cfg.mla
                total += B * S * (a.kv_lora_rank + a.qk_rope_head_dim) * 2
            elif mixer == SSM:
                ss = cfg.ssm
                di = ss.expand * d
                nh = ss.num_heads or di // ss.head_dim
                total += B * (nh * ss.head_dim * ss.d_state * 4
                              + (ss.conv_width - 1) * (di + 2 * ss.num_groups
                                                       * ss.d_state) * 2)
        return total

    if shape.kind == "train":
        return 26.0 * P + act_bytes(B * S, 24.0)
    if shape.kind == "prefill":
        return 2.0 * P + act_bytes(B * S, 8.0) + cache_bytes()
    # decode: weights (active) + cache read/write dominate
    from repro_torch.configs.base import count_active_params
    return 2.0 * count_active_params(cfg) + cache_bytes() + 8.0 * B * d * L
