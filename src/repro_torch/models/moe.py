"""Mixture-of-experts layer (counterpart of ``repro.models.moe``).

Two implementations share one router:

- ``dense``: every expert computes every token, combined by the top-k
  weights.  Exact (no token dropping); the oracle of the tests.
- ``gather`` (default): capacity-bounded dispatch per sequence, as the
  reference's: a stable sort of the (token, choice) assignments by expert,
  positions within each expert from the count starts, capacity
  ``min(S, max(4, ceil(S * k * capacity_factor / E)))``, and assignments past
  it dropped.  The kept tokens are gathered into an (E, B*C, D) buffer, each
  expert's kept tokens first in its block of B*C slots and zeros after them;
  each expert's FFN is a batched product over its kept rows alone
  (``ops.ragged_mm``: on a card in float32, a kernel that reads each
  expert's row count on the device), and each token sums its k weighted
  slots.  Its router-to-slots dispatch, expert products and combine are
  ``model.moe.*`` spans of ``obs.device_spans`` (the dispatch and combine
  also in their backwards), and in the forward phase it counts the
  assignments kept under capacity, its slots and the slot rows the products
  compute (``moe.*``).

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
from repro_torch.kernels import moe_gemm
from repro_torch.kernels.ops import ragged_mm
from repro_torch.models.layers import apply_ffn, gelu
from repro_torch.obs.device_spans import current_recorder, phase, span

_IMPL = {"impl": "gather"}  # module switch: "gather" | "dense"


def set_moe_impl(impl: str):
    if impl not in ("gather", "dense"):
        raise ValueError(f"moe impl {impl!r} is not 'gather' or 'dense'")
    _IMPL["impl"] = impl


def moe_impl() -> str:
    return _IMPL["impl"]


def router_probs(p: dict, x) -> torch.Tensor:
    """x: (B,S,D) -> float32 probs (B,S,E)."""
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"].float())
    return torch.softmax(logits, dim=-1)


def _counts(ids, n: int) -> torch.Tensor:
    """How often each of ``0 .. n-1`` occurs in the integer tensor ``ids``
    (int64, shape (n,)): ``torch.bincount(ids, minlength=n)`` for ids below
    ``n``, through an op that has a meta kernel, so a dry-run traces it."""
    ids = ids.reshape(-1)
    return torch.zeros(n, dtype=torch.long, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def balance_stats(probs, expert_ids, num_experts: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(router probabilities summed over tokens (E,), assignments per expert
    (E,)), both float32: the sums behind ``load_balance_loss``."""
    psum = probs.reshape(-1, num_experts).sum(0)
    return psum, _counts(expert_ids, num_experts).float()


def balance_loss(psum, counts, n_tokens: int, num_experts: int) -> torch.Tensor:
    """E * sum_e f_e * P_e from ``balance_stats`` sums over ``n_tokens``."""
    pe = psum / n_tokens
    fe = counts / torch.clamp(counts.sum(), min=1.0)
    return num_experts * torch.sum(fe * pe)


def load_balance_loss(probs, expert_ids, num_experts: int) -> torch.Tensor:
    """Switch-transformer aux loss of one batch (float32 scalar)."""
    return balance_loss(*balance_stats(probs, expert_ids, num_experts),
                        probs.numel() // num_experts, num_experts)


def _expert_ffn_batched(xg, p, ff_kind: str, rows):
    """xg: (E, T, D) tokens grouped by expert, expert e's ``rows[e]`` first
    and zeros after them -> (E, T, D), zeros past ``rows[e]`` (silu and gelu
    keep a zero row zero)."""
    if ff_kind == FF_SWIGLU:
        g = ragged_mm(xg, p["w_gate"], rows)
        u = ragged_mm(xg, p["w_up"], rows)
        h = F.silu(g.float()).to(xg.dtype) * u
    else:
        h = gelu(ragged_mm(xg, p["w_up"], rows))
    return ragged_mm(h, p["w_down"], rows)


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
        with span("model.moe.dispatch"):
            (slot_of_asg,) = ctx.saved_tensors
            gx = _rows(g, slot_of_asg)                             # (B*S*k, D)
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
        with span("model.moe.combine"):
            (asg_of_slot,) = ctx.saved_tensors
            return _rows(g, asg_of_slot), None, None


def _gather_dispatch(cfg: ModelConfig, x, ids):
    """Capacity-bounded dispatch, *per sequence* (GShard-style groups), with
    per-sequence capacity C = ceil(S * k * capacity_factor / E): the kept
    tokens as (E, B*C, D) slots, each expert's ``rows[e]`` kept tokens first
    (sequence by sequence, each in its order of positions); ``rows``, int32
    (E,); and the (slot_of_asg, asg_of_slot) tables that ``_gather_combine``
    reads."""
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
        counts = _counts(exp_ids + row * E, B * E).view(B, E)
        starts = torch.cumsum(counts, dim=-1) - counts             # (B, E)
        pos_sorted = torch.arange(N, device=dev)[None, :] - starts.gather(1, exp_sorted)
        # un-sort the positions back to assignment order
        pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)

        cap = int(max(4, -(-N * m.capacity_factor // E)))          # ceil
        cap = min(cap, S)
        # slots are expert-major, E blocks of B*C: expert e's kept tokens of
        # sequence b start at off[b, e], after those of the sequences before
        # it, so its rows[e] kept tokens are the first rows of its block
        kept = torch.clamp(counts, max=cap)                        # (B, E)
        off = torch.cumsum(kept, dim=0) - kept
        rows = kept.sum(0).to(torch.int32)                         # (E,)
        n_slots = E * B * cap
        slot_of_asg = torch.where(
            pos < cap, exp_ids * (B * cap) + off.gather(1, exp_ids) + pos,
            n_slots).reshape(-1)                                   # n_slots = dropped
        # the assignment in each slot, B*N = empty; every dropped assignment
        # writes the extra sentinel slot, which is cut off
        asg_of_slot = torch.full((n_slots + 1,), B * N, dtype=torch.long, device=dev)
        asg_of_slot[slot_of_asg] = torch.arange(B * N, device=dev)
        asg_of_slot = asg_of_slot[:n_slots]
        tok_of_slot = asg_of_slot // k                             # B*S = empty

    rec = current_recorder()
    if rec.enabled and phase() == "forward":
        rec.count("moe.kept", (pos < cap).sum())
        rec.count("moe.slots", n_slots)
        rec.count("moe.rows", moe_gemm.rows_computed(rows, B * cap, x))
    xg = _Dispatch.apply(x.reshape(B * S, D), tok_of_slot, slot_of_asg, k)
    return xg.view(E, B * cap, D), rows, (slot_of_asg, asg_of_slot)


def _gather_combine(yg, weights, slot_of_asg, asg_of_slot):
    """Expert outputs (E, B*C, D) -> (B, S, D): each token's k slots, weighted
    and summed."""
    D = yg.shape[-1]
    y_asg = _Combine.apply(yg.reshape(-1, D), slot_of_asg, asg_of_slot)
    return torch.sum(y_asg.view(*weights.shape, D) * weights[..., None], dim=2)


def _route(m, p: dict, x):
    """(float32 probs (B,S,E), top-k weights normalised to sum 1 in x's
    dtype, expert ids), each (B,S,k) but the probs."""
    probs = router_probs(p, x)                                     # float32
    weights, ids = torch.topk(probs, m.experts_per_token, dim=-1)  # (B,S,k)
    weights = (weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
               ).to(x.dtype)
    return probs, weights, ids


def moe_layer(cfg: ModelConfig, p: dict, x):
    """(y, (psum, counts)): the layer's output and its ``balance_stats``.
    The gather path opens ``model.moe.dispatch`` (router to ``_Dispatch``),
    ``model.moe.experts`` and ``model.moe.combine`` spans."""
    m = cfg.moe
    if _IMPL["impl"] == "dense":
        probs, weights, ids = _route(m, p, x)
        y = _moe_dense(cfg, p, x, weights, ids)
    else:
        with span("model.moe.dispatch"):
            probs, weights, ids = _route(m, p, x)
            xg, rows, tables = _gather_dispatch(cfg, x, ids)
        with span("model.moe.experts"):
            yg = _expert_ffn_batched(xg, p, m.ff_kind, rows)
        with span("model.moe.combine"):
            y = _gather_combine(yg, weights, *tables)
    if m.num_shared_experts:
        y = y + apply_ffn(p["shared"], x, m.ff_kind)
    return y, balance_stats(probs, ids, m.num_experts)


def moe_forward(cfg: ModelConfig, p: dict, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, aux_loss). x: (B,S,D)."""
    m = cfg.moe
    y, (psum, counts) = moe_layer(cfg, p, x)
    aux = balance_loss(psum, counts, x.shape[0] * x.shape[1], m.num_experts)
    return y, aux * m.router_aux_weight
