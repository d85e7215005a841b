"""Mixture-of-experts layer (counterpart of ``repro.models.moe``).

Two implementations share one router:

- ``dense``: every expert computes every token, combined by the top-k
  weights.  Exact (no token dropping); the oracle of the tests.
- ``gather`` (default): capacity-bounded dispatch per sequence, as the
  reference's: a stable sort of the (token, choice) assignments by expert,
  positions within each expert from the bincount starts, capacity
  ``min(S, max(4, ceil(S * k * capacity_factor / E)))``, and assignments past
  it dropped.  The kept tokens are gathered into an (E, B*C, D) buffer, each
  expert's FFN is one batched product, and each token sums its k weighted
  slots.

Where the reference scatter-adds (the combine, and the gather's transpose
in the backward), the port gathers each token's k slots and sums them in a
fixed order (``_Dispatch``, ``_Combine``): ``index_add_`` on a card sums with
atomics, in an order that changes from run to run.  The sums equal the
reference's up to rounding, and are deterministic.

The reference pads the experts to a multiple of an ``experts`` mesh axis when
one exists; on one card there is none (its ``rule_axis_size`` is 1), and the
port pads nothing.

The load-balance loss is ``E * sum_e f_e * P_e`` over the whole batch: ``f_e``
the expert's share of all assignments, ``P_e`` its mean router probability.
``balance_stats`` returns the two sums behind it, which add across batch
shards, so a trainer that runs its shards one at a time forms the global loss
(``balance_loss``) from them.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import FF_SWIGLU, ModelConfig
from repro_torch.models.layers import apply_ffn, gelu

_IMPL = {"impl": "gather"}  # module switch: "gather" | "dense"


def set_moe_impl(impl: str):
    if impl not in ("gather", "dense"):
        raise ValueError(f"moe impl {impl!r} is not 'gather' or 'dense'")
    _IMPL["impl"] = impl


def router_probs(p: dict, x) -> torch.Tensor:
    """x: (B,S,D) -> float32 probs (B,S,E)."""
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"].float())
    return torch.softmax(logits, dim=-1)


def balance_stats(probs, expert_ids, num_experts: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(router probabilities summed over tokens (E,), assignments per expert
    (E,)), both float32: the sums behind ``load_balance_loss``."""
    psum = probs.reshape(-1, num_experts).sum(0)
    counts = torch.bincount(expert_ids.reshape(-1), minlength=num_experts)
    return psum, counts.float()


def balance_loss(psum, counts, n_tokens: int, num_experts: int) -> torch.Tensor:
    """E * sum_e f_e * P_e from ``balance_stats`` sums over ``n_tokens``."""
    pe = psum / n_tokens
    fe = counts / torch.clamp(counts.sum(), min=1.0)
    return num_experts * torch.sum(fe * pe)


def load_balance_loss(probs, expert_ids, num_experts: int) -> torch.Tensor:
    """Switch-transformer aux loss of one batch (float32 scalar)."""
    return balance_loss(*balance_stats(probs, expert_ids, num_experts),
                        probs.numel() // num_experts, num_experts)


def _expert_ffn_batched(xg, p, ff_kind: str):
    """xg: (E, T, D) tokens grouped by expert -> (E, T, D)."""
    if ff_kind == FF_SWIGLU:
        g = torch.bmm(xg, p["w_gate"])
        u = torch.bmm(xg, p["w_up"])
        h = F.silu(g.float()).to(xg.dtype) * u
    else:
        h = gelu(torch.bmm(xg, p["w_up"]))
    return torch.bmm(h, p["w_down"])


def _moe_dense(cfg: ModelConfig, p: dict, x, weights, ids):
    """All-experts path: (B,S,E) combine weights, exact."""
    m = cfg.moe
    comb = torch.sum(F.one_hot(ids, m.num_experts).float()
                     * weights[..., None].float(), dim=2)          # (B,S,E)
    if m.ff_kind == FF_SWIGLU:
        g = torch.einsum("bsd,edf->bsef", x, p["w_gate"])
        u = torch.einsum("bsd,edf->bsef", x, p["w_up"])
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = gelu(torch.einsum("bsd,edf->bsef", x, p["w_up"]))
    y = torch.einsum("bsef,efd->bsed", h, p["w_down"])
    return torch.einsum("bsed,bse->bsd", y, comb.to(x.dtype))


def _rows(src, index):
    """src[index] along dim 0; an index past the end (the sentinel) gives a
    row of zeros."""
    n = src.shape[0]
    out = src.index_select(0, index.clamp(max=n - 1))
    return out.masked_fill((index >= n)[:, None], 0)


class _Dispatch(torch.autograd.Function):
    """Tokens (B*S, D) -> slots (E*B*C, D): a slot holds the token of its
    assignment, or zeros.  The backward sums each token's k slots in a fixed
    order."""

    @staticmethod
    def forward(ctx, x, tok_of_slot, slot_of_asg, k: int):
        ctx.save_for_backward(slot_of_asg)
        ctx.k = k
        return _rows(x, tok_of_slot)

    @staticmethod
    def backward(ctx, g):
        (slot_of_asg,) = ctx.saved_tensors
        gx = _rows(g, slot_of_asg)                                 # (B*S*k, D)
        return gx.view(-1, ctx.k, g.shape[1]).sum(1), None, None, None


class _Combine(torch.autograd.Function):
    """Slots (E*B*C, D) -> assignments (B*S*k, D): each assignment's slot,
    or zeros where it was dropped.  Each slot holds at most one assignment,
    so the backward is a gather too."""

    @staticmethod
    def forward(ctx, yg, slot_of_asg, asg_of_slot):
        ctx.save_for_backward(asg_of_slot)
        return _rows(yg, slot_of_asg)

    @staticmethod
    def backward(ctx, g):
        (asg_of_slot,) = ctx.saved_tensors
        return _rows(g, asg_of_slot), None, None


def _moe_gather(cfg: ModelConfig, p: dict, x, weights, ids):
    """Capacity-bounded dispatch, *per sequence* (GShard-style groups), with
    per-sequence capacity C = ceil(S * k * capacity_factor / E)."""
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.num_experts, m.experts_per_token
    N = S * k
    dev = x.device

    with torch.no_grad():
        exp_ids = ids.reshape(B, N)                                # (B, N)
        # per-row stable sort by expert; position-within-expert via group starts
        order = torch.argsort(exp_ids, dim=-1, stable=True)
        exp_sorted = exp_ids.gather(1, order)
        row = torch.arange(B, device=dev)[:, None]
        counts = torch.bincount((exp_ids + row * E).reshape(-1),
                                minlength=B * E).view(B, E)
        starts = torch.cumsum(counts, dim=-1) - counts             # (B, E)
        pos_sorted = torch.arange(N, device=dev)[None, :] - starts.gather(1, exp_sorted)
        # un-sort the positions back to assignment order
        pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)

        cap = int(max(4, -(-N * m.capacity_factor // E)))          # ceil
        cap = min(cap, S)
        # slots are expert-major over the batch, (E, B, C): each expert's
        # tokens are one contiguous block of the batched product
        n_slots = E * B * cap
        slot_of_asg = torch.where(pos < cap, exp_ids * (B * cap) + row * cap + pos,
                                  n_slots).reshape(-1)             # n_slots = dropped
        # the assignment in each slot, B*N = empty; every dropped assignment
        # writes the extra sentinel slot, which is cut off
        asg_of_slot = torch.full((n_slots + 1,), B * N, dtype=torch.long, device=dev)
        asg_of_slot[slot_of_asg] = torch.arange(B * N, device=dev)
        asg_of_slot = asg_of_slot[:n_slots]
        tok_of_slot = asg_of_slot // k                             # B*S = empty

    xg = _Dispatch.apply(x.reshape(B * S, D), tok_of_slot, slot_of_asg, k)
    yg = _expert_ffn_batched(xg.view(E, B * cap, D), p, m.ff_kind)
    y_asg = _Combine.apply(yg.reshape(n_slots, D), slot_of_asg, asg_of_slot)
    return torch.sum(y_asg.view(B, S, k, D) * weights[..., None], dim=2)


def moe_layer(cfg: ModelConfig, p: dict, x):
    """(y, (psum, counts)): the layer's output and its ``balance_stats``."""
    m = cfg.moe
    probs = router_probs(p, x)                                     # float32
    weights, ids = torch.topk(probs, m.experts_per_token, dim=-1)  # (B,S,k)
    weights = (weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
               ).to(x.dtype)
    if _IMPL["impl"] == "dense":
        y = _moe_dense(cfg, p, x, weights, ids)
    else:
        y = _moe_gather(cfg, p, x, weights, ids)
    if m.num_shared_experts:
        y = y + apply_ffn(p["shared"], x, m.ff_kind)
    return y, balance_stats(probs, ids, m.num_experts)


def moe_forward(cfg: ModelConfig, p: dict, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, aux_loss). x: (B,S,D)."""
    m = cfg.moe
    y, (psum, counts) = moe_layer(cfg, p, x)
    aux = balance_loss(psum, counts, x.shape[0] * x.shape[1], m.num_experts)
    return y, aux * m.router_aux_weight
