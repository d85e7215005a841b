"""Plain PyTorch versions of every hand-written kernel.

They are the CPU path (a kernel wrapper given a CPU tensor runs these) and
the ground truth the kernels are held against on the card.  Each mirrors its
counterpart in ``repro.kernels.ref`` / ``repro.kernels.pack``;
``ssd_chunked_ref`` mirrors ``repro.models.ssm.ssd_chunked``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

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


def ssd_ref(x, dt, a_log, b, c):
    """Naive O(L) SSD recurrence (fp32 state), the slow-but-exact oracle.

    x: (B,L,H,P); dt: (B,L,H) post-softplus; a_log: (H,); b,c: (B,L,G,N).
    h_t = exp(A*dt_t) h_{t-1} + dt_t * (B_t (x) x_t);  y_t = h_t C_t
    """
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    A = -torch.exp(a_log.float())
    bh = b.float().repeat_interleave(rep, dim=2)             # (B,L,H,N)
    ch = c.float().repeat_interleave(rep, dim=2)
    xf, dtf = x.float(), dt.float()
    h = x.new_zeros((B, H, P, N), dtype=torch.float32)
    ys = []
    for t in range(L):
        a_t = torch.exp(dtf[:, t] * A)                       # (B,H)
        h = h * a_t[..., None, None] + \
            (dtf[:, t, :, None] * xf[:, t])[..., None] * bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype)                # (B,L,H,P)


def _ssd_chunk(h_prev, xq, dtq, bq, cq, A, tri, rep: int):
    """One chunk of ``ssd_chunked_ref``: (h_prev, inputs) -> (h, y) in fp32."""
    xq, dtq = xq.float(), dtq.float()
    bh = bq.float().repeat_interleave(rep, dim=2)            # (B,Q,H,N)
    ch = cq.float().repeat_interleave(rep, dim=2)
    cum = torch.cumsum(dtq * A, dim=1)                       # (B,Q,H)
    # intra-chunk quadratic term; the mask goes in before exp: above the
    # diagonal cum_i - cum_j > 0 can overflow, and exp(-inf) = 0 keeps both
    # the forward and its gradient finite there
    diff = cum[:, :, None, :] - cum[:, None, :, :]           # (B,Q,Q,H)
    decay = torch.exp(torch.where(tri[None, :, :, None], diff,
                                  torch.full_like(diff, float("-inf"))))
    cb = torch.einsum("bqhs,bkhs->bqkh", ch, bh)
    scores = cb * decay * dtq[:, None, :, :]                 # dt_k on columns
    y = torch.einsum("bqkh,bkhp->bqhp", scores, xq)
    # inter-chunk contribution from the carried state
    y = y + torch.einsum("bqh,bqhs,bhps->bqhp", torch.exp(cum), ch, h_prev)
    # state update
    tail = torch.exp(cum[:, -1:, :] - cum)                   # (B,Q,H)
    sstate = torch.einsum("bqh,bqhs,bqhp->bhps", tail * dtq, bh, xq)
    h = h_prev * torch.exp(cum[:, -1, :])[..., None, None] + sstate
    return h, y


def ssd_chunked_ref(x, dt, a_log, b, c, *, chunk: int):
    """Chunked SSD, the plain version of ``csrc/ssd_scan.cu`` (counterpart of
    ``repro.models.ssm.ssd_chunked``).

    x: (B,L,H,P); dt: (B,L,H) post-softplus; a_log: (H,); b,c: (B,L,G,N)
    with G dividing H.  Returns y: (B,L,H,P) in x's type.  A Python loop over
    chunks carries the (B,H,P,N) fp32 state; each chunk body runs under
    ``torch.utils.checkpoint``, so only one chunk's (B,Q,Q,H) tensors are
    live in the forward and in the backward."""
    B, L, H, P = x.shape
    G = b.shape[2]
    Q = min(chunk, L)
    if L % Q or H % G:
        raise ValueError(f"ssd needs L % chunk == 0 and H % G == 0, got "
                         f"L={L}, chunk={Q}, H={H}, G={G}")
    A = -torch.exp(a_log.float())                            # (H,) negative
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    h = x.new_zeros((B, H, P, b.shape[3]), dtype=torch.float32)
    ys = []
    for c0 in range(0, L, Q):
        sl = slice(c0, c0 + Q)
        h, y = checkpoint(_ssd_chunk, h, x[:, sl], dt[:, sl], b[:, sl],
                          c[:, sl], A, tri, H // G, use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype)


def ssd_split_ref(x, dt, a_log, b, c, *, chunk: int):
    """The three phases of ``csrc/ssd_scan.cu`` in plain PyTorch: chunk
    states, state passing, chunk scan.  Same function as ``ssd_chunked_ref``,
    computed in the kernel's order.

    x: (B,L,H,P); dt: (B,L,H) post-softplus; a_log: (H,); b,c: (B,L,G,N).
    Returns (y (B,L,H,P) in x's type, the state passed out of the last chunk
    (B,H,P,N) float32)."""
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    Q = min(chunk, L)
    if L % Q or H % G:
        raise ValueError(f"ssd needs L % chunk == 0 and H % G == 0, got "
                         f"L={L}, chunk={Q}, H={H}, G={G}")
    nc, rep = L // Q, H // G
    A = -torch.exp(a_log.float())
    xc = x.float().reshape(B, nc, Q, H, P)
    dtc = dt.float().reshape(B, nc, Q, H)
    bc = b.float().reshape(B, nc, Q, G, N).repeat_interleave(rep, dim=3)
    cc = c.float().reshape(B, nc, Q, G, N).repeat_interleave(rep, dim=3)
    # 1. chunk states: cumsum, and each chunk's own contribution to the state
    cum = torch.cumsum(dtc * A, dim=2)                          # (B,nc,Q,H)
    w = torch.exp(cum[:, :, -1:, :] - cum) * dtc
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", w, bc, xc)  # (B,nc,H,P,N)
    # 2. state passing: the state that enters each chunk
    h = x.new_zeros((B, H, P, N), dtype=torch.float32)
    h_in = []
    for ci in range(nc):
        h_in.append(h)
        h = h * torch.exp(cum[:, ci, -1, :])[..., None, None] + states[:, ci]
    h_in = torch.stack(h_in, dim=1)                             # (B,nc,H,P,N)
    # 3. chunk scan: masked before exp, as in ``_ssd_chunk``
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (B,nc,Q,Q,H)
    decay = torch.exp(torch.where(tri[:, :, None], diff,
                                  torch.full_like(diff, float("-inf"))))
    scores = (torch.einsum("bcqhn,bckhn->bcqkh", cc, bc) * decay
              * dtc[:, :, None, :, :])
    y = (torch.einsum("bcqkh,bckhp->bcqhp", scores, xc)
         + torch.einsum("bcqh,bcqhn,bchpn->bcqhp", torch.exp(cum), cc, h_in))
    return y.reshape(B, L, H, P).to(x.dtype), h


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
