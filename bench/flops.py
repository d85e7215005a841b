"""The yardstick's arithmetic: the card's peaks, the model FLOPs of a training
step, and a causal flash-attention forward's operations and bytes, all from
shapes.

Model FLOPs are ``6 * active matmul parameters * tokens`` (forward and
backward; the embedding lookup is no product, the output head is one; an
MoE layer counts its router and its k active experts, not the capacity
slots the port computes) plus causal attention at half the score blocks,
``4 * B * H * hd * S(S+1)/2`` a layer forward and three times that forward
and backward.  Recomputation is not counted.
"""
from __future__ import annotations

from typing import Optional

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores (the rate of
# every configuration here, float32 with TF32 off) and HBM3 bandwidth, at
# the card's 700 W limit.  A precision with no entry has no peak, and the
# metrics that need one leave themselves out.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peak(device_name: str, key: str) -> Optional[float]:
    return PEAKS.get(device_name, {}).get(key)


def active_matmul_params(cfg: dict) -> int:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    kv, hd = cfg["num_key_value_heads"], cfg.get("head_dim") or d // h
    f = cfg["intermediate_size"]
    attn = d * hd * (h + 2 * kv) + h * hd * d
    experts = cfg.get("num_local_experts", 0)
    if experts:
        ff = cfg["num_experts_per_tok"] * 3 * d * f + d * experts
    else:
        ff = 3 * d * f
    return cfg["num_hidden_layers"] * (attn + ff) + d * cfg["vocab_size"]


def causal_attention_ops(batch: int, seq: int, heads: int, head_dim: int) -> float:
    """Operations of one causal attention forward (QK^T and PV over the
    S(S+1)/2 unmasked pairs)."""
    return 4.0 * batch * heads * head_dim * seq * (seq + 1) / 2


def train_step_flops(cfg: dict, batch: int, seq: int, attn_layers: int) -> float:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or d // h
    return (6.0 * active_matmul_params(cfg) * batch * seq
            + 3.0 * attn_layers * causal_attention_ops(batch, seq, h, hd))


def flash_fwd_bytes(batch: int, seq: int, heads: int, kv_heads: int,
                    head_dim: int) -> float:
    """float32 q, k, v read once, the output written once, and the row
    log-sum-exp written once."""
    return 4.0 * (batch * seq * head_dim * (2 * heads + 2 * kv_heads) + batch * heads * seq)
