"""Attention mixers (counterpart of ``repro.models.attention``): GQA
softmax attention (``qk_norm`` included; causal, bidirectional as an
encoder's, or cross-attention over keys and values given from outside) and
DeepSeek-V2 multi-head latent attention (MLA), in train, prefill and decode
mode, and their caches.  Layout (B,S,H,hd) throughout.

The cache is a plain dict of tensors, written in place: prefill writes the
prompt's entries, a decode step the new token's at ``pos``.  GQA caches keys
and values; MLA only the compressed per-token latent (``ckv``, after
``kv_norm``) and the shared rope key (``krope``, after RoPE).  Decode
assumes one position across the batch (an int ``pos``), as the serving
CLI's synchronous batched decode does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.blocked import blocked_attention
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
                 cache: Optional[dict] = None, pos: Optional[int] = None,
                 kv_override=None, causal: bool = True):
    """x: (B,S,D) -> (y (B,S,D), cache).

    Self-attention (``kv_override`` None): q and k get RoPE (after
    ``qk_norm``).  train: causal through the flash kernel (the plain version
    for CPU tensors), or bidirectional (``causal=False``, the encoder's)
    through the blocked twin, as the reference takes flash only for causal
    self-attention; no cache.  prefill: the same, and the prompt's k/v are
    written into ``cache[:, :S]``.  decode: k/v are written at ``pos`` and
    the queries attend over the cache's first ``pos + S`` entries
    (``_grouped_attention``, outside any kernel, as in the reference).

    Cross-attention: ``kv_override=(k, v)``, keys and values already
    projected from the encoder's output (or read from the cross cache), taken
    as given, with no RoPE and no ``qk_norm``; q gets RoPE only when
    ``causal``.  train and prefill attend through the blocked twin, decode
    through ``_grouped_attention`` over all of k and v; ``cache`` is
    returned untouched."""
    S = x.shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    scale = cfg.resolved_head_dim ** -0.5
    if kv_override is not None:
        k, v = kv_override
        if causal:
            q = apply_rope(q, positions, cfg.rope_theta)
        if mode == "decode":
            out = _grouped_attention(q, k, v, causal=causal, q_pos0=pos, scale=scale)
        else:
            out = blocked_attention(q, k, v, causal, scale)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:          # the plain rmsnorm over the head dim, as the reference's
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if mode == "decode":
        cache["k"][:, pos:pos + S] = k
        cache["v"][:, pos:pos + S] = v
        out = _grouped_attention(q, cache["k"], cache["v"], causal=causal,
                                 q_pos0=pos, scale=scale, kv_len=pos + S)
    else:
        if mode == "prefill":
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
        if causal:
            out = ops.flash_attention(q, k, v, causal=True, scale=scale)
        else:
            out = blocked_attention(q, k, v, False, scale)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
    a = cfg.mla
    return {"ckv": torch.zeros((batch, max_len, a.kv_lora_rank), dtype=dtype,
                               device=device),
            "krope": torch.zeros((batch, max_len, a.qk_rope_head_dim),
                                 dtype=dtype, device=device)}


def mla_forward(cfg: ModelConfig, p: dict, x, *, positions, mode: str = "train",
                cache: Optional[dict] = None, pos: Optional[int] = None,
                absorb: bool = False):
    """x: (B,S,D) -> (y (B,S,D), cache).  Causal multi-head latent attention.

    train and prefill: per-head keys (the nope part from the latent, the
    shared rope key broadcast over heads) and values are expanded from the
    latent, linear in S, and attended through the blocked twin with scale
    ``(nope + rope) ** -0.5``; prefill writes ``ckv`` and ``krope`` into
    ``cache[:, :S]``.  decode: the new token's latent is written at ``pos``
    and the queries attend over the cache masked causally from ``pos`` and
    to its first ``pos + S`` entries.  ``absorb`` (decode only, as in the
    reference) folds W_UK into the query and takes scores and context
    against the latent cache itself, without expanding per-head K and V."""
    a = cfg.mla
    S = x.shape[1]
    nope, r = a.qk_nope_head_dim, a.kv_lora_rank
    if a.q_lora_rank:
        cq = rmsnorm(torch.matmul(x, p["wq_a"]), p["q_norm"], cfg.norm_eps)
        q = torch.einsum("bsl,lhk->bshk", cq, p["wq_b"])
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)

    ckv_kr = torch.matmul(x, p["wkv_a"])
    ckv = rmsnorm(ckv_kr[..., :r], p["kv_norm"], cfg.norm_eps)
    # the shared (single-head) rope key
    krope = apply_rope(ckv_kr[:, :, None, r:], positions, cfg.rope_theta)[:, :, 0]
    w_uk, w_uv = p["wkv_b"][..., :nope], p["wkv_b"][..., nope:]
    scale = (nope + a.qk_rope_head_dim) ** -0.5

    if mode != "decode":
        if mode == "prefill":
            cache["ckv"][:, :S] = ckv
            cache["krope"][:, :S] = krope
        # each piece is dropped once it is copied into its full form: at
        # deepseek-v2's width a prefill's expanded q/k/v are 1-2 GB each
        k_nope = torch.einsum("btl,lhn->bthn", ckv, w_uk)
        k_full = torch.cat([k_nope, krope[:, :, None].expand(
            -1, -1, k_nope.shape[2], -1)], dim=-1)
        del k_nope
        v_full = torch.einsum("btl,lhv->bthv", ckv, w_uv)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        del q, q_nope, q_rope
        out = blocked_attention(q_full, k_full, v_full, True, scale)
        return torch.einsum("bshv,hvd->bsd", out, p["wo"]), cache

    cache["ckv"][:, pos:pos + S] = ckv
    cache["krope"][:, pos:pos + S] = krope
    ckv_all, krope_all = cache["ckv"], cache["krope"]
    if absorb:
        q_lat = torch.einsum("bshn,lhn->bshl", q_nope, w_uk)
        scores = torch.einsum("bshl,btl->bhst", q_lat, ckv_all)
    else:
        k_nope = torch.einsum("btl,lhn->bthn", ckv_all, w_uk)
        scores = torch.einsum("bshn,bthn->bhst", q_nope, k_nope)
    scores = scores + torch.einsum("bshr,btr->bhst", q_rope, krope_all)
    scores = scores.float() * scale
    tpos = torch.arange(ckv_all.shape[1], device=x.device)
    spos = pos + torch.arange(S, device=x.device)
    scores = scores.masked_fill((spos[:, None] < tpos[None, :]) | (tpos >= pos + S),
                                NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    if absorb:
        ctx_lat = torch.einsum("bhst,btl->bshl", probs, ckv_all)
        out = torch.einsum("bshl,lhv->bshv", ctx_lat, w_uv)
    else:
        v_full = torch.einsum("btl,lhv->bthv", ckv_all, w_uv)
        out = torch.einsum("bhst,bthv->bshv", probs, v_full)
    return torch.einsum("bshv,hvd->bsd", out, p["wo"]), cache
