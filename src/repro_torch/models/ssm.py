"""Mamba-2 SSD block, train mode (counterpart of ``repro.models.ssm``).

The SSD recurrence per head (state N, head dim P):
    h_t = a_t * h_{t-1} + dt_t * (B_t outer x_t)     h in R^{P x N}
    y_t = h_t @ C_t + D * x_t                        a_t = exp(A * dt_t), A < 0

Training runs the chunked algorithm through ``ops.ssd``: the hand-written
kernel on the card, the plain ``ref.ssd_chunked_ref`` on the CPU, and that
plain version for the backward.  Prefill, decode and their cache wait for the
serving slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import gated_rmsnorm

ssd_chunked = ref.ssd_chunked_ref        # the plain version, as in the reference


def _dims(cfg: ModelConfig):
    ss = cfg.ssm
    d_inner = ss.expand * cfg.d_model
    nh = ss.num_heads or d_inner // ss.head_dim
    gn = ss.num_groups * ss.d_state
    conv_dim = d_inner + 2 * gn
    return ss, d_inner, nh, gn, conv_dim


def _causal_conv(u, w, b):
    """Depthwise causal conv. u: (B,L,C); w: (W,C); b: (C,).  Unrolled
    shifted multiply-adds, summed in the reference's order."""
    W, L = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, W - 1, 0))
    y = torch.zeros_like(u)
    for i in range(W):
        y = y + pad[:, i:i + L, :] * w[i]
    return y + b


def ssm_forward(cfg: ModelConfig, p: dict, xin):
    """Full Mamba-2 block in train mode. xin: (B,L,D) -> (B,L,D)."""
    ss, d_inner, nh, gn, conv_dim = _dims(cfg)
    B, L, D = xin.shape
    zxbcdt = torch.einsum("bld,de->ble", xin, p["in_proj"])
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt_raw = zxbcdt[..., d_inner + conv_dim:]

    xbc_c = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xbc_c = F.silu(xbc_c.float()).to(xin.dtype)
    xs = xbc_c[..., :d_inner].reshape(B, L, nh, ss.head_dim)
    b = xbc_c[..., d_inner:d_inner + gn].reshape(B, L, ss.num_groups, ss.d_state)
    c = xbc_c[..., d_inner + gn:].reshape(B, L, ss.num_groups, ss.d_state)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())      # (B,L,H)

    y = ops.ssd(xs, dt, p["a_log"], b, c, chunk=ss.chunk)
    y = y + p["d_skip"].float()[None, None, :, None].to(y.dtype) * xs.to(y.dtype)
    y = y.reshape(B, L, d_inner).to(xin.dtype)
    y = gated_rmsnorm(y, z, p["out_norm"], cfg.norm_eps)
    return torch.einsum("ble,ed->bld", y, p["out_proj"])
