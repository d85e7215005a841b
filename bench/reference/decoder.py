"""Plain PyTorch reference of the decoder-only transformer the training cells
run (the LLaMA layout: RMSNorm, GQA attention with rotate-half RoPE, and a
SwiGLU feed-forward or a top-k mixture of SwiGLU experts), its AdamW step,
and the readings that decide ``correct``.

Float32, TF32 off (``precision="tf32"`` turns it on: the control).  Written
from the published architecture and the configuration file alone: it
imports nothing of the port and takes nothing the port produced.  Weights
come from ``bench.weights``, batches from ``bench.stream``.

What the port adds to the published model, and this reference follows, is
stated in the configuration's ``departures``: the embedding table padded to
a multiple of ``vocab_pad_to`` rows (the padded logits masked), and the MoE
layer's per-sequence expert capacity ``min(S, max(4, ceil(S * k * cf /
E)))``, past which a sequence's assignments to an expert are dropped in
(token, choice) order.  The load-balance loss is the global batch's, per
MoE layer ``w * E * sum_e f_e * P_e``: ``f_e`` the expert's share of all
assignments (dropped ones included), ``P_e`` its mean router probability.

The gradient is accumulated over blocks of ``ROWS`` sequences, each layer
under ``torch.utils.checkpoint``, so the reference fits on the card once the
port's state is freed.  The ``f_e`` are constants of a step: a pass without
gradients counts them first, then each block's loss carries its share of
the aux loss.  Stacked layer leaves are split into per-layer leaves that
are views of them, so the update lands in the stacked tensor.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench import weights

NEG_INF = torch.finfo(torch.float32).min
ROWS = 2                       # sequences a gradient block
BLOCKS = "decoder/blocks/sub0/"


def dims(cfg: dict) -> SimpleNamespace:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    pad = cfg["departures"]["vocab_pad_to"]["as_run"]
    experts = cfg.get("num_local_experts", 0)
    a = cfg["assumed"]
    return SimpleNamespace(
        d=d, heads=h, kv=cfg["num_key_value_heads"], hd=cfg.get("head_dim") or d // h,
        ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        vocab_rows=-(-cfg["vocab_size"] // pad) * pad, layers=cfg["num_hidden_layers"],
        eps=cfg["rms_norm_eps"], theta=cfg["rope_theta"],
        tie=cfg["tie_word_embeddings"], experts=experts,
        top_k=cfg.get("num_experts_per_tok", 0),
        capacity=(cfg["departures"]["moe_capacity_factor"]["as_run"] if experts else 0.0),
        aux_w=cfg.get("router_aux_loss_coef", 0.0), adamw=a["adamw"],
        peak_lr=a["peak_lr"], warmup=a["warmup_steps"], total=a["total_steps"],
        min_ratio=a["lr_min_ratio"])


def param_specs(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], str, int]]:
    """{flat key: (shape, init, fan_in)} of every leaf; the layers' leaves
    stacked on a leading layer axis."""
    c = dims(cfg)
    L, d = c.layers, c.d
    s = {"embed": ((c.vocab_rows, d), "normal", d), "final_norm": ((d,), "ones", 0)}
    if not c.tie:
        s["lm_head"] = ((d, c.vocab_rows), "normal", d)
    b = BLOCKS
    s[b + "mixer_norm"] = ((L, d), "ones", 0)
    s[b + "mixer/wq"] = ((L, d, c.heads, c.hd), "normal", d)
    s[b + "mixer/wk"] = ((L, d, c.kv, c.hd), "normal", d)
    s[b + "mixer/wv"] = ((L, d, c.kv, c.hd), "normal", d)
    s[b + "mixer/wo"] = ((L, c.heads, c.hd, d), "normal", c.heads * c.hd)
    s[b + "ff_norm"] = ((L, d), "ones", 0)
    if c.experts:
        e = c.experts
        s[b + "ff/router"] = ((L, d, e), "normal", d)
        s[b + "ff/w_gate"] = ((L, e, d, c.ff), "normal", d)
        s[b + "ff/w_up"] = ((L, e, d, c.ff), "normal", d)
        s[b + "ff/w_down"] = ((L, e, c.ff, d), "normal", c.ff)
    else:
        s[b + "ff/w_gate"] = ((L, d, c.ff), "normal", d)
        s[b + "ff/w_up"] = ((L, d, c.ff), "normal", d)
        s[b + "ff/w_down"] = ((L, c.ff, d), "normal", c.ff)
    return s


def causal_attention_layers(cfg: dict) -> int:
    return cfg["num_hidden_layers"]


def lr_at(c: SimpleNamespace, step: int) -> float:
    """Linear warm-up to the peak over ``warmup`` steps, then a cosine to
    ``min_ratio`` of it at ``total``."""
    if step < c.warmup:
        return c.peak_lr * min((step + 1) / max(c.warmup, 1), 1.0)
    t = min(max((step - c.warmup) / max(c.total - c.warmup, 1), 0.0), 1.0)
    return c.peak_lr * (c.min_ratio + (1 - c.min_ratio) * 0.5 * (1 + math.cos(math.pi * t)))


# -- the model -----------------------------------------------------------------

def _tf32(x):
    """x with its mantissa rounded to TF32's 10 bits (forward only): the
    control's arithmetic where the card's TF32 is not at hand."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (r - x.detach())


def _mm(eq, a, b, emulate: bool):
    if emulate:
        a, b = _tf32(a), _tf32(b)
    return torch.einsum(eq, a, b)


def _rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rope(x, theta):
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x.chunk(2, -1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attention(q, k, v, em):
    S, group = q.shape[1], q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(group, 2), v.repeat_interleave(group, 2)
    scores = _mm("bshd,bthd->bhst", q, k, em) * q.shape[-1] ** -0.5
    future = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    probs = scores.masked_fill(future, NEG_INF).softmax(-1)
    return _mm("bhst,bthd->bshd", probs, v, em)


def _swiglu(x, wg, wu, wd, em, eq):
    gate, up, down = eq
    return _mm(down, F.silu(_mm(gate, x, wg, em)) * _mm(up, x, wu, em), wd, em)


def _moe(c, x, p, em):
    """(y, router probabilities summed over the tokens (E,), assignments
    per expert (E,)).  Every gather reads each row at most once, and the k
    choices of a token are summed in order, so the layer and its backward
    are deterministic (no atomic adds)."""
    B, S, D = x.shape
    E, k = c.experts, c.top_k
    probs = _mm("bsd,de->bse", x, p["ff/router"], em).softmax(-1)
    w, ids = probs.topk(k, -1)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    N = S * k
    cap = min(S, max(4, math.ceil(N * c.capacity / E)))
    flat = ids.reshape(B, N)
    onehot = F.one_hot(flat, E)
    rank = ((onehot.cumsum(1) * onehot).sum(-1) - 1).reshape(-1)   # place in its queue
    asg = torch.nonzero(rank < cap)[:, 0]                          # kept (row, token, choice)
    slot = (flat.reshape(-1)[asg] * B + asg // N) * cap + rank[asg]
    empty = B * N                                                  # the zero row
    src = torch.full((E * B * cap,), empty, dtype=torch.long, device=x.device)
    src[slot] = asg
    dst = torch.full((B * N,), E * B * cap, dtype=torch.long, device=x.device)
    dst[asg] = slot
    zero = x.new_zeros(1, D)
    x_asg = torch.cat([x.reshape(B * S, D).repeat_interleave(k, 0), zero])
    xs = x_asg[src].view(E, B * cap, D)
    ys = _swiglu(xs, p["ff/w_gate"], p["ff/w_up"], p["ff/w_down"], em,
                 ("etd,edf->etf", "etd,edf->etf", "etf,efd->etd")).reshape(-1, D)
    y_asg = torch.cat([ys, zero])[dst].view(B, S, k, D)
    return ((y_asg * w[..., None]).sum(2), probs.reshape(-1, E).sum(0),
            torch.bincount(flat.reshape(-1), minlength=E).float())


def _layer(c, em, x, p):
    h = _rmsnorm(x, p["mixer_norm"], c.eps)
    q = _rope(_mm("bsd,dhk->bshk", h, p["mixer/wq"], em), c.theta)
    k = _rope(_mm("bsd,dhk->bshk", h, p["mixer/wk"], em), c.theta)
    v = _mm("bsd,dhk->bshk", h, p["mixer/wv"], em)
    x = x + _mm("bshk,hkd->bsd", _attention(q, k, v, em), p["mixer/wo"], em)
    h = _rmsnorm(x, p["ff_norm"], c.eps)
    if c.experts:
        y, psum, counts = _moe(c, h, p, em)
        return x + y, psum, counts
    y = _swiglu(h, p["ff/w_gate"], p["ff/w_up"], p["ff/w_down"], em,
                ("bsd,df->bsf", "bsd,df->bsf", "bsf,fd->bsd"))
    return x + y, None, None


def _counts(c, em, params, layers, tokens, block_rows) -> List[torch.Tensor]:
    """Each MoE layer's assignments per expert over ``tokens``."""
    total = [torch.zeros(c.experts, device=tokens.device) for _ in layers]
    with torch.no_grad():
        for lo in range(0, tokens.shape[0], block_rows):
            x = F.embedding(tokens[lo:lo + block_rows], params["embed"])
            for i, p in enumerate(layers):
                x, _, counts = _layer(c, em, x, p)
                total[i] += counts
    return total


def _block_loss(c, em, params, layers, tokens, labels, counts, n_tokens, n_labels):
    x = F.embedding(tokens, params["embed"])
    aux = x.new_zeros(())
    for i, p in enumerate(layers):
        x, psum, _ = checkpoint(_layer, c, em, x, p, use_reentrant=False)
        if c.experts:
            f = counts[i] / counts[i].sum().clamp_min(1.0)
            aux = aux + c.aux_w * c.experts * torch.dot(f, psum) / n_tokens
    h = _rmsnorm(x, params["final_norm"], c.eps)
    head = params["embed"].T if c.tie else params["lm_head"]
    logits = _mm("bsd,dv->bsv", h, head, em)
    if c.vocab_rows > c.vocab:
        pad = torch.arange(c.vocab_rows, device=logits.device) >= c.vocab
        logits = logits.masked_fill(pad, NEG_INF)
    tgt = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    xent = ((logits.logsumexp(-1) - tgt) * (labels >= 0)).sum()
    return xent / n_labels + aux


# -- training ------------------------------------------------------------------

@contextmanager
def _precision(precision: str, device: torch.device):
    if precision not in ("fp32", "tf32"):
        raise ValueError(f"precision {precision!r} is not fp32 or tf32")
    if device.type != "cuda":
        yield
        return
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = \
        precision == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _sqnorm(ts) -> float:
    return sum(float(torch.linalg.vector_norm(t, dtype=torch.float64)) ** 2 for t in ts)


def train(cfg: dict, batches: Sequence[Dict[str, np.ndarray]], seed: int, *,
          device, precision: str = "fp32", rows: Optional[Sequence[int]] = None,
          steps: int = 3, block_rows: int = ROWS) -> dict:
    """Train ``steps`` steps from the seed's weights on ``batches`` (only the
    batch ``rows`` given, as the faults do; gradients accumulated over
    blocks of ``block_rows`` sequences) and return the readings:
    ``losses`` (each step's xent + aux), ``grad_norms`` ({leaf: norm of the
    clipped first gradient, from the first moment after step 1}) and
    ``update_norms`` ({leaf: norm of its change over the steps})."""
    device = torch.device(device)
    c = dims(cfg)
    specs = param_specs(cfg)
    em = precision == "tf32" and device.type != "cuda"
    a = c.adamw
    with _precision(precision, device):
        params = {k: weights.make(shape, seed, k, init, fan, device)
                  for k, (shape, init, fan) in specs.items()}
        top = {k: t.requires_grad_() for k, t in params.items() if not k.startswith(BLOCKS)}
        layers = [{k[len(BLOCKS):]: t.detach()[i].requires_grad_()
                   for k, t in params.items() if k.startswith(BLOCKS)}
                  for i in range(c.layers)]
        leaves = list(top.values()) + [t for p in layers for t in p.values()]
        m = [torch.zeros_like(t) for t in leaves]
        v = [torch.zeros_like(t) for t in leaves]
        out = {"losses": []}
        for step in range(steps):
            batch = batches[step]
            pick = slice(None) if rows is None else list(rows)
            tokens = torch.from_numpy(batch["tokens"][pick]).to(device, torch.long)
            labels = torch.from_numpy(batch["labels"][pick]).to(device, torch.long)
            n_tokens = tokens.numel()
            n_labels = max(float((labels >= 0).sum()), 1.0)
            counts = (_counts(c, em, params, layers, tokens, block_rows)
                      if c.experts else None)
            loss = 0.0
            for lo in range(0, tokens.shape[0], block_rows):
                hi = lo + block_rows
                block = _block_loss(c, em, params, layers, tokens[lo:hi], labels[lo:hi],
                                    counts, n_tokens, n_labels)
                block.backward()
                loss += float(block.detach())
            out["losses"].append(loss)
            _adamw(c, a, leaves, m, v, step)
            if step == 0:
                out["grad_norms"] = _leaf_norms(params, top, layers, dict(zip(
                    [id(t) for t in leaves], m)), 1.0 / (1.0 - a["b1"]))
        out["update_norms"] = {}
        for k, (shape, init, fan) in specs.items():
            start = weights.make(shape, seed, k, init, fan, device)
            out["update_norms"][k] = math.sqrt(_sqnorm([params[k].detach() - start]))
            del start
    return out


@torch.no_grad()
def _adamw(c, a, leaves, m, v, step):
    grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in leaves]
    gnorm = math.sqrt(_sqnorm(grads))
    scale = min(1.0, a["clip_norm"] / max(gnorm, 1e-9))
    lr = lr_at(c, step)
    bc1, bc2 = 1.0 - a["b1"] ** (step + 1), 1.0 - a["b2"] ** (step + 1)
    for p, g, mi, vi in zip(leaves, grads, m, v):
        g = g * scale
        mi.mul_(a["b1"]).add_((1 - a["b1"]) * g)
        vi.mul_(a["b2"]).add_((1 - a["b2"]) * g.square())
        p.sub_(lr * ((mi / bc1) / ((vi / bc2).sqrt() + a["eps"]) + a["weight_decay"] * p))
        p.grad = None


def _leaf_norms(params, top, layers, moment_of, scale) -> Dict[str, float]:
    """{flat key: scale * norm of the leaf's moment}, a stacked leaf's over
    all its layers."""
    out = {k: scale * math.sqrt(_sqnorm([moment_of[id(t)]])) for k, t in top.items()}
    for k in params:
        if k.startswith(BLOCKS):
            name = k[len(BLOCKS):]
            out[k] = scale * math.sqrt(_sqnorm([moment_of[id(p[name])] for p in layers]))
    return out
