"""Blocked (flash-style) attention in plain torch: the twin of
``repro.kernels.blocked``, which the reference computes in jnp outside any
Pallas kernel, so plain torch is its port here, not a stand-in for a kernel.

An online softmax over KV blocks of ``block_k`` keeps the live working set
at one (B*KV, G*Sq, block_k) score tile instead of the (Sq, Sk) matrix.
The tail is padded to whole blocks, the padding masked by ``kv_len``.  It
takes ``q_pos0`` (the absolute position of q[:, 0], for causal masking
against a longer KV), causal or not, and a v head dim that may differ from
q/k's (MLA: 192 and 128).  GQA stays in grouped form: repeated KV is never
materialised.  It computes in float32 and returns ``q.dtype``.

The backward is the reference's flash recomputation (``_blocked_vjp_bwd``):
only (q, k, v, out, lse) are saved, and dq/dk/dv are accumulated in one
pass over the KV blocks.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG = torch.finfo(torch.float32).min
DEFAULT_BLOCK_K = 512


def _padded(k, v, kv_len: Optional[int], block_k: int):
    """(k, v) padded on the sequence axis to whole blocks, kv_len (the
    padding's mask, where none was given), block_k, number of blocks."""
    Sk = k.shape[1]
    block_k = min(block_k, max(Sk, 1))
    pad = -Sk % block_k
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        if kv_len is None:
            kv_len = Sk
    return k, v, kv_len, block_k, (Sk + pad) // block_k


def _grouped(t, KV: int):
    """(B,S,KV*G,h) -> a new float32 (B*KV, G*S, h): rows grouped by KV head."""
    B, S, H, h = t.shape
    out = torch.empty((B, KV, H // KV, S, h), dtype=torch.float32, device=t.device)
    out.copy_(t.reshape(B, S, KV, H // KV, h).permute(0, 2, 3, 1, 4))
    return out.view(B * KV, (H // KV) * S, h)


def _block(t, j: int, block_k: int):
    """Block ``j`` of padded (B,Skp,KV,h) k or v -> float32 (B*KV, block_k, h)."""
    B, _, KV, h = t.shape
    blk = t[:, j * block_k:(j + 1) * block_k]
    return blk.permute(0, 2, 1, 3).reshape(B * KV, block_k, h).float()


def _invalid(j: int, block_k: int, spos, kv_len: Optional[int], causal: bool):
    """Mask of the (G*Sq, block_k) tile's invalid entries, or None."""
    tpos = j * block_k + torch.arange(block_k, device=spos.device)
    bad = None
    if kv_len is not None:
        bad = (tpos >= kv_len)[None, :]
    if causal:
        c = spos[:, None] < tpos[None, :]
        bad = c if bad is None else bad | c
    return bad


def _row_positions(Sq: int, G: int, q_pos0: int, device):
    """Absolute position of each row of a (G*Sq, ...) tile."""
    return (q_pos0 + torch.arange(Sq, device=device)).repeat(G)


def _forward(q, k, v, causal, scale, q_pos0, kv_len, block_k):
    """-> (out (B,Sq,H,hdv) in q.dtype, lse (B*KV, G*Sq) float32)."""
    B, Sq, H, _ = q.shape
    KV, hdv = k.shape[2], v.shape[-1]
    kp, vp, kv_len, block_k, nb = _padded(k, v, kv_len, block_k)
    qg = _grouped(q, KV).mul_(scale)
    spos = _row_positions(Sq, H // KV, q_pos0, q.device)
    rows = qg.shape[:2]
    m = torch.full(rows, NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros(rows, dtype=torch.float32, device=q.device)
    acc = torch.zeros((*rows, hdv), dtype=torch.float32, device=q.device)
    for j in range(nb):
        s = torch.bmm(qg, _block(kp, j, block_k).transpose(1, 2))
        bad = _invalid(j, block_k, spos, kv_len, causal)
        if bad is not None:
            s.masked_fill_(bad, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = s.sub_(m_new[..., None]).exp_()
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc.mul_(alpha[..., None]).baddbmm_(p, _block(vp, j, block_k))
        m = m_new
        del s, p
    l = l.clamp_min_(1e-30)
    out = acc.div_(l[..., None])
    out = out.reshape(B, KV, H // KV, Sq, hdv).permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, hdv).to(q.dtype), m + torch.log(l)


def _backward(q, k, v, out, lse, dout, causal, scale, q_pos0, kv_len, block_k):
    B, Sq, H, hd = q.shape
    Sk, KV, hdv = k.shape[1], k.shape[2], v.shape[-1]
    kp, vp, kv_len, block_k, nb = _padded(k, v, kv_len, block_k)
    qg = _grouped(q, KV)
    dog = _grouped(dout, KV)
    delta = (dog * _grouped(out, KV)).sum(-1)             # rowsum(dout * out)
    spos = _row_positions(Sq, H // KV, q_pos0, q.device)
    dq = torch.zeros_like(qg)
    dks, dvs = [], []
    for j in range(nb):
        kf, vf = _block(kp, j, block_k), _block(vp, j, block_k)
        s = torch.bmm(qg, kf.transpose(1, 2)).mul_(scale)
        p = s.sub_(lse[..., None]).exp_()
        bad = _invalid(j, block_k, spos, kv_len, causal)
        if bad is not None:
            p.masked_fill_(bad, 0.0)
        dvs.append(torch.bmm(p.transpose(1, 2), dog))
        dp = torch.bmm(dog, vf.transpose(1, 2))
        ds = p.mul_(dp.sub_(delta[..., None])).mul_(scale)
        del dp
        dq.baddbmm_(ds, kf)
        dks.append(torch.bmm(ds.transpose(1, 2), qg))
        del s, p, ds

    def ungroup_kv(blocks, h):
        t = torch.cat(blocks, dim=1).reshape(B, KV, -1, h)[:, :, :Sk]
        return t.permute(0, 2, 1, 3)

    dq = dq.reshape(B, KV, H // KV, Sq, hd).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return (dq.to(q.dtype), ungroup_kv(dks, hd).to(k.dtype),
            ungroup_kv(dvs, hdv).to(v.dtype))


class _Blocked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_pos0, kv_len, block_k):
        out, lse = _forward(q, k, v, causal, scale, q_pos0, kv_len, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, q_pos0, kv_len, block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_backward(q, k, v, out, lse, dout, *ctx.args),
                None, None, None, None, None)


def blocked_attention(q, k, v, causal: bool = True, scale: Optional[float] = None,
                      q_pos0: int = 0, kv_len: Optional[int] = None,
                      block_k: int = DEFAULT_BLOCK_K):
    """q: (B,Sq,H,hd); k: (B,Sk,KV,hd); v: (B,Sk,KV,hdv) -> (B,Sq,H,hdv) in
    q.dtype, differentiable in q, k and v.  kv_len: keys at index >= kv_len
    are masked."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return _Blocked.apply(q, k, v, causal, scale, q_pos0, kv_len, block_k)


__all__ = ["blocked_attention", "DEFAULT_BLOCK_K"]
