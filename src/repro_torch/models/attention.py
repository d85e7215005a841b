"""GQA attention mixer, train mode (counterpart of the GQA branch of
``repro.models.attention.attn_forward``, ``qk_norm`` included).  Layout
(B,S,H,hd) throughout."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, rmsnorm


def attn_forward(cfg: ModelConfig, p: dict, x, *, positions):
    """x: (B,S,D) -> (B,S,D), causal self-attention through the flash kernel
    (the plain version for CPU tensors)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:          # the plain rmsnorm over the head dim, as the reference's
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=True,
                              scale=cfg.resolved_head_dim ** -0.5)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])
