"""Mamba-2 SSD block (counterpart of ``repro.models.ssm``) in train, prefill
and decode mode, and its cache.

The SSD recurrence per head (state N, head dim P):
    h_t = a_t * h_{t-1} + dt_t * (B_t outer x_t)     h in R^{P x N}
    y_t = h_t @ C_t + D * x_t                        a_t = exp(A * dt_t), A < 0

Train and prefill run the chunked algorithm through ``ops.ssd``: the
hand-written kernel on the card, the plain ``ref.ssd_chunked_ref`` on the
CPU, and that plain version for the backward.  Prefill also keeps the last
W-1 conv inputs and the final state (``ssd_final_state``, plain torch as in
the reference); decode runs the one-token conv window and the recurrence in
float32.  The cache (conv window, state ``h``) is written in place.
"""
from __future__ import annotations

from typing import Optional

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


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """The conv window in the model's dtype; the state ``h`` always float32."""
    ss, d_inner, nh, gn, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, ss.conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, nh, ss.head_dim, ss.d_state),
                         dtype=torch.float32, device=device),
    }


def _causal_conv(u, w, b):
    """Depthwise causal conv. u: (B,L,C); w: (W,C); b: (C,).  Unrolled
    shifted multiply-adds, summed in the reference's order."""
    W, L = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, W - 1, 0))
    y = torch.zeros_like(u)
    for i in range(W):
        y = y + pad[:, i:i + L, :] * w[i]
    return y + b


def ssd_final_state(x, dt, a_log, b):
    """The state (B,H,P,N) float32 after the whole sequence, in one pass
    (prefill -> decode).  x: (B,L,H,P); dt: (B,L,H) post-softplus;
    b: (B,L,G,N)."""
    H, G = x.shape[2], b.shape[2]
    A = -torch.exp(a_log.float())
    dt = dt.float()
    cum = torch.cumsum(dt * A, dim=1)                        # (B,L,H)
    tail = torch.exp(cum[:, -1:, :] - cum)                   # (B,L,H)
    bh = b.float().repeat_interleave(H // G, dim=2)          # (B,L,H,N)
    return torch.einsum("blh,blhn,blhp->bhpn", tail * dt, bh, x.float())


def ssm_forward(cfg: ModelConfig, p: dict, xin, *, mode: str = "train",
                cache: Optional[dict] = None):
    """Full Mamba-2 block. xin: (B,L,D) -> (y (B,L,D), cache); prefill and
    decode update ``cache`` in place, train takes none."""
    ss, d_inner, nh, gn, conv_dim = _dims(cfg)
    B, L, D = xin.shape
    zxbcdt = torch.einsum("bld,de->ble", xin, p["in_proj"])
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt_raw = zxbcdt[..., d_inner + conv_dim:]

    if mode == "decode":
        window = torch.cat([cache["conv"], xbc], dim=1)      # (B,W,conv)
        cache["conv"].copy_(window[:, 1:])
        xbc_c = torch.einsum("bwc,wc->bc", window, p["conv_w"])[:, None, :] \
            + p["conv_b"]
    else:
        xbc_c = _causal_conv(xbc, p["conv_w"], p["conv_b"])
        if mode == "prefill":        # the last W-1 inputs, before the conv
            pad = F.pad(xbc, (0, 0, ss.conv_width - 1, 0))
            cache["conv"].copy_(pad[:, L:L + ss.conv_width - 1])
    xbc_c = F.silu(xbc_c.float()).to(xin.dtype)
    xs = xbc_c[..., :d_inner].reshape(B, L, nh, ss.head_dim)
    b = xbc_c[..., d_inner:d_inner + gn].reshape(B, L, ss.num_groups, ss.d_state)
    c = xbc_c[..., d_inner + gn:].reshape(B, L, ss.num_groups, ss.d_state)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())      # (B,L,H)

    if mode == "decode":
        A = -torch.exp(p["a_log"].float())
        a_t = torch.exp(dt[:, 0] * A)                             # (B,H)
        rep = nh // ss.num_groups
        bh = b[:, 0].float().repeat_interleave(rep, dim=1)        # (B,H,N)
        ch = c[:, 0].float().repeat_interleave(rep, dim=1)
        xf = xs[:, 0].float()                                     # (B,H,P)
        h = cache["h"] * a_t[..., None, None] + \
            (dt[:, 0, :, None] * xf)[..., None] * bh[:, :, None, :]
        cache["h"].copy_(h)
        y = torch.einsum("bhpn,bhn->bhp", h, ch)[:, None]         # (B,1,H,P)
    else:
        y = ops.ssd(xs, dt, p["a_log"], b, c, chunk=ss.chunk)
        if mode == "prefill":
            cache["h"].copy_(ssd_final_state(xs, dt, p["a_log"], b))

    y = y + p["d_skip"].float()[None, None, :, None].to(y.dtype) * xs.to(y.dtype)
    y = y.reshape(B, L, d_inner).to(xin.dtype)
    y = gated_rmsnorm(y, z, p["out_norm"], cfg.norm_eps)
    return torch.einsum("ble,ed->bld", y, p["out_proj"]), cache
