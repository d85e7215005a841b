"""Plain PyTorch versions of every hand-written kernel.

They are the CPU path (a kernel wrapper given a CPU tensor runs these) and
the ground truth the kernels are held against on the card.  Each mirrors its
counterpart in ``repro.kernels.ref`` / ``repro.kernels.pack``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

NEG_INF = torch.finfo(torch.float32).min
PACK_LANE = 128
PACK_BLOCK_ROWS = 8


def _gqa_scores(q, k, causal: bool, scale: float):
    """(B,KV,G,Sq,Sk) float32 scaled scores, causal entries set to NEG_INF."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * scale
    if causal:
        Sk = k.shape[1]
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    return scores


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None):
    """q: (B,S,H,hd); k,v: (B,S,KV,hd). Naive fp32-softmax attention, GQA."""
    B, Sq, H, hd = q.shape
    scale = hd ** -0.5 if scale is None else scale
    probs = torch.softmax(_gqa_scores(q, k, causal, scale), dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, Sq, H, hd)


def attention_lse_ref(q, k, *, causal: bool = True,
                      scale: Optional[float] = None):
    """Row log-sum-exp of the scaled scores, (B,H,S) float32 (what the flash
    kernel writes for a later backward kernel)."""
    B, Sq, H, hd = q.shape
    scale = hd ** -0.5 if scale is None else scale
    lse = torch.logsumexp(_gqa_scores(q, k, causal, scale), dim=-1)
    return lse.reshape(B, H, Sq)


def rmsnorm_ref(x, w, eps: float = 1e-5):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def pack_leaves_ref(leaves: Sequence[torch.Tensor], *,
                    block_rows: int = PACK_BLOCK_ROWS,
                    lane: int = PACK_LANE) -> torch.Tensor:
    """Same-dtype leaves -> one (total_blocks*block_rows, lane) buffer,
    leaf-major, each leaf raveled and zero-padded to a block multiple."""
    block = block_rows * lane
    parts = []
    for leaf in leaves:
        v = leaf.reshape(-1)
        pad = (-v.numel()) % block
        parts.append(v)
        if pad:
            parts.append(v.new_zeros(pad))
    return torch.cat(parts).reshape(-1, lane)
