"""Decoder stack (counterpart of ``repro.models.transformer``): each layer's
mixer is attention or the Mamba-2 SSD block, and its FFN dense, MoE or none,
as ``cfg.mixer_at`` / ``cfg.ff_at`` say.

Block parameters are stacked with a leading layer axis
(``decoder/blocks/sub0/...``) as the reference scans them.  Each layer runs
under ``torch.utils.checkpoint(use_reentrant=False)``, the counterpart of the
reference's remat policy "full": only the residual stream is kept between
layers and the layer is recomputed in the backward.

The layer axis is split once, by ``_split_layers``, for every caller: a
stacked leaf that takes a gradient gets per-layer leaves whose hooks add
into its ``.grad``.

Where the reference sums each MoE layer's aux loss, the port returns each
MoE layer's ``moe.balance_stats`` sums: the loss is formed from them
(``model.aux_loss``), over one batch or over a trainer's shards together.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, FF_MOE, FF_NONE, SSM, ModelConfig
from repro_torch.models.attention import attn_forward
from repro_torch.models.layers import apply_ffn, rmsnorm
from repro_torch.models.moe import moe_layer
from repro_torch.models.ssm import ssm_forward


def apply_layer(cfg: ModelConfig, p: dict, x, layer_idx: int, *, positions):
    """RMSNorm -> mixer -> residual [-> RMSNorm -> FFN -> residual].
    Returns (x, the MoE layer's (psum, counts), or None)."""
    mixer = cfg.mixer_at(layer_idx)
    h = rmsnorm(x, p["mixer_norm"], cfg.norm_eps)
    if mixer == ATTN:
        x = x + attn_forward(cfg, p["mixer"], h, positions=positions)
    elif mixer == SSM:
        x = x + ssm_forward(cfg, p["mixer"], h)
    else:
        raise ValueError(mixer)
    ff = cfg.ff_at(layer_idx)
    stats = None
    if ff != FF_NONE:
        h = rmsnorm(x, p["ff_norm"], cfg.norm_eps)
        if ff == FF_MOE:
            y, stats = moe_layer(cfg, p["ff"], h)
        else:
            y = apply_ffn(p["ff"], h, ff)
        x = x + y
    return x, stats


def _grad_into(stacked: torch.Tensor, i: int):
    """A post-accumulate-grad hook: add the leaf's gradient into layer ``i``
    of ``stacked.grad`` and drop it from the leaf.  It looks the gradient up
    when it runs, so a leaf that outlives its step holds no gradient."""
    def hook(leaf: torch.Tensor):
        stacked.grad[i].add_(leaf.grad)
        leaf.grad = None
    return hook


def _split_layers(tree, n: int):
    """Stacked {leaf: (L, ...)} tree -> list of L per-layer trees sharing its
    storage.  Where a stacked leaf takes a gradient, each layer's slice is a
    leaf of its own whose hook adds its gradient into the stacked ``.grad``
    as soon as autograd accumulates it: through ``torch.unbind`` a backward
    would hold every layer's gradient of a leaf until the last one arrived
    (at granite-moe-3b-a800m's size, 13 GB beside the summed gradients)."""
    if isinstance(tree, dict):
        per = {k: _split_layers(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    track = tree.requires_grad and torch.is_grad_enabled()
    if track and not tree.is_leaf:
        raise ValueError("stacked block parameters that take a gradient must "
                         "be leaf tensors")
    if track and tree.grad is None:
        # before the forward, as the step's first allocation: allocated in
        # the backward it would land among freed activations
        tree.grad = torch.zeros_like(tree)
    layers = []
    for i in range(n):
        leaf = tree.detach()[i]
        if track:
            leaf.requires_grad_()
            leaf.register_post_accumulate_grad_hook(_grad_into(tree, i))
        layers.append(leaf)
    return layers


def decoder(cfg: ModelConfig, dparams: dict, x, *, positions):
    """(x, [(psum, counts) of each MoE layer])."""
    prefix, n = cfg.scan_layers()
    moe_stats = []
    for lp in _split_layers(dparams["blocks"]["sub0"], n):
        x, stats = checkpoint(apply_layer, cfg, lp, x, prefix, positions=positions,
                              use_reentrant=False)
        if stats is not None:
            moe_stats.append(stats)
    return x, moe_stats
