"""Shared layer primitives (counterpart of ``repro.models.layers``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import FF_SWIGLU

NEG_INF = torch.finfo(torch.float32).min


def rmsnorm(x, weight, eps: float):
    """RMSNorm with float32 statistics, cast back to x's type."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def gated_rmsnorm(x, gate, weight, eps: float):
    """Mamba-2 output norm: rmsnorm(x * silu(gate))."""
    return rmsnorm(x * F.silu(gate.float()).to(x.dtype), weight, eps)


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """Rotate-half RoPE with float32 angles.  x: (..., S, H, hd);
    positions: (S,) or (B, S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs        # (..., S, hd/2)
    angles = angles[..., None, :]                         # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_ffn(p: dict, x, kind: str):
    if kind != FF_SWIGLU:
        raise ValueError(f"ffn kind {kind!r} is not ported yet")
    g = torch.matmul(x, p["w_gate"])
    u = torch.matmul(x, p["w_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.matmul(h, p["w_down"])


def _xent_chunk(h, w_head, labels, valid_vocab: int):
    logits = torch.matmul(h, w_head).float()
    Vp = logits.shape[-1]
    if valid_vocab and valid_vocab < Vp:
        pad = torch.arange(Vp, device=logits.device) >= valid_vocab
        logits = logits.masked_fill(pad, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - tgt) * mask).sum(), mask.sum()


def chunked_softmax_xent(hidden, w_head, labels, *, chunk: int = 1024,
                         valid_vocab: int = 0):
    """Cross-entropy over a large vocab without materialising (B,S,V).

    hidden: (B,S,D); w_head: (D,Vp); labels: (B,S), -1 = masked.  Each
    sequence chunk runs under ``torch.utils.checkpoint``, so only one chunk's
    logits are live in the forward and in the backward.  ``valid_vocab``
    masks padded vocab columns.  Returns (total_loss_sum, total_weight)."""
    S = hidden.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"seq_len {S} is not a multiple of chunk {chunk}")
    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    weight = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, S, chunk):
        loss, w = checkpoint(_xent_chunk, hidden[:, c0:c0 + chunk], w_head,
                             labels[:, c0:c0 + chunk], valid_vocab,
                             use_reentrant=False)
        loss_sum = loss_sum + loss
        weight = weight + w
    return loss_sum, weight
