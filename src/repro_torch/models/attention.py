"""GQA attention mixer (counterpart of the GQA branch of
``repro.models.attention``, ``qk_norm`` included) in train, prefill and
decode mode, and its KV cache.  Layout (B,S,H,hd) throughout.

The cache is a plain dict of tensors, written in place: prefill writes the
prompt's keys and values, a decode step the new token's at ``pos``.  Decode
assumes one position across the batch (an int ``pos``), as the serving
CLI's synchronous batched decode does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import NEG_INF, apply_rope, rmsnorm


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device) -> dict:
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, max_len, kv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _grouped_attention(q, k, v, *, causal: bool, q_pos0: int, scale: float,
                       kv_len: Optional[int] = None):
    """q: (B,Sq,H,hd); k,v: (B,Sk,KV,hd).  GQA in grouped form, without
    repeating KV; float32 scores and softmax.

    q_pos0: absolute position of q[:, 0] (causal masking against a cache).
    kv_len: if set, keys at index >= kv_len are masked (decode: cache tail).
    """
    B, Sq, H, hd = q.shape
    KV, Sk = k.shape[2], k.shape[1]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * scale
    tpos = torch.arange(Sk, device=q.device)
    if causal:
        spos = q_pos0 + torch.arange(Sq, device=q.device)
        scores = scores.masked_fill(spos[:, None] < tpos[None, :], NEG_INF)
    if kv_len is not None:
        scores = scores.masked_fill(tpos >= kv_len, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, Sq, H, hd)


def attn_forward(cfg: ModelConfig, p: dict, x, *, positions, mode: str = "train",
                 cache: Optional[dict] = None, pos: Optional[int] = None):
    """x: (B,S,D) -> (y (B,S,D), cache).  Causal self-attention.

    train: through the flash kernel (the plain version for CPU tensors); no
    cache.  prefill: the same, and the prompt's k/v are written into
    ``cache[:, :S]``.  decode: k/v are written at ``pos`` and the queries
    attend over the cache's first ``pos + S`` entries (``_grouped_attention``,
    outside any kernel, as in the reference)."""
    S = x.shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:          # the plain rmsnorm over the head dim, as the reference's
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    scale = cfg.resolved_head_dim ** -0.5
    if mode == "decode":
        cache["k"][:, pos:pos + S] = k
        cache["v"][:, pos:pos + S] = v
        out = _grouped_attention(q, cache["k"], cache["v"], causal=True,
                                 q_pos0=pos, scale=scale, kv_len=pos + S)
    else:
        if mode == "prefill":
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
        out = ops.flash_attention(q, k, v, causal=True, scale=scale)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache
