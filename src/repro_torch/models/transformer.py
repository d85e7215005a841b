"""Decoder and encoder stacks (counterpart of ``repro.models.transformer``):
each decoder layer's mixer is GQA attention, MLA or the Mamba-2 SSD block,
and its FFN dense, MoE or none, as ``cfg.mixer_at`` / ``cfg.ff_at`` say; in
an encoder-decoder model a cross-attention block over the encoder's output
sits between them, and the encoder (bidirectional attention and a dense FFN
a layer, ``encoder``) runs first.

The prefix layers (``first_dense``, and a depth's remainder modulo the
layer period, ``cfg.scan_layers()``) run first, one by one, with unstacked
parameters (``decoder/prefix/layer{i}/...``) and caches
(``prefix/layer{i}/{kv | ssm}``).  The other layers run in blocks of one
layer period (1, or 8 for jamba's hybrid), as the reference scans them:
sub-layer j of every block is stacked with a leading block axis
(``decoder/blocks/sub{j}/...``), and so is its serving cache
(``blocks/sub{j}/{kv: {k, v} | {ckv, krope}} | {ssm: {conv, h}}``, with
``cross: {ck, cv}`` beside it in an encoder-decoder model); block b
runs sub0 .. sub{period-1}, and sub j is layer ``prefix + j`` to
``cfg.mixer_at`` / ``cfg.ff_at``, as in the reference.  A depth may have no
stacked layers at all.  In train mode each layer, prefix layers included,
runs under ``torch.utils.checkpoint(use_reentrant=False)``, the counterpart
of the reference's remat policy "full" (which the reference applies to each
sub-layer of a hybrid block, to a whole block of one layer, and not to the
prefix layers): only the residual stream is kept between layers and the
layer is recomputed in the backward.  Prefill and decode call the layer
directly, as the reference's ``_maybe_remat`` does.

An MLA layer decodes through the W_UK-absorbed form and trains and
prefills through the expanded one, as the reference's ``_MLA_ABSORB``
defaults say (``set_mla_absorb`` changes them).

The block axis of each ``sub{j}`` (and the encoder's layer axis) is split
once, by ``_split_layers``, for every caller: a stacked leaf that takes a
gradient gets per-block leaves whose hooks add into its ``.grad``; a cache
leaf gets per-block views, so a layer's in-place writes land in the stacked
cache.

Where the reference sums each MoE layer's aux loss, the port returns each
MoE layer's ``moe.balance_stats`` sums: the loss is formed from them
(``model.aux_loss``), over one batch or over a trainer's shards together.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, FF_MOE, FF_NONE, MLA, SSM, ModelConfig
from repro_torch.models.attention import attn_forward, mla_forward
from repro_torch.models.layers import apply_ffn, rmsnorm
from repro_torch.models.moe import moe_layer
from repro_torch.models.ssm import ssm_forward
from repro_torch.obs.device_spans import span

MODES = ("train", "prefill", "decode")
_MLA_ABSORB = {"decode": True, "prefill": False, "train": False}


def set_mla_absorb(mode: str, value: bool):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    _MLA_ABSORB[mode] = value


def apply_layer(cfg: ModelConfig, p: dict, x, layer_idx: int, *, positions,
                mode: str = "train", cache: Optional[dict] = None,
                pos: Optional[int] = None, enc_out=None):
    """RMSNorm -> mixer -> residual [-> RMSNorm -> cross-attention ->
    residual] [-> RMSNorm -> FFN -> residual].  Returns (x, the layer's
    cache ({"kv": ...} or {"ssm": ...}, and {"cross": ...} in an
    encoder-decoder model, updated in place; None in train mode), the MoE
    layer's (psum, counts) or None).

    The cross block (a layer with ``cross`` parameters) projects the keys
    and values of ``enc_out`` (B, S_enc, D) with ``cross/wk``, ``cross/wv``
    in train and prefill (prefill writes them into ``cache["cross"]``'s
    ``ck``, ``cv``) and reads them from the cache in decode."""
    mixer = cfg.mixer_at(layer_idx)
    h = rmsnorm(x, p["mixer_norm"], cfg.norm_eps)
    if mixer == ATTN:
        y, _ = attn_forward(cfg, p["mixer"], h, positions=positions, mode=mode,
                            cache=cache["kv"] if cache else None, pos=pos)
    elif mixer == MLA:
        y, _ = mla_forward(cfg, p["mixer"], h, positions=positions, mode=mode,
                           cache=cache["kv"] if cache else None, pos=pos,
                           absorb=_MLA_ABSORB[mode])
    elif mixer == SSM:
        y, _ = ssm_forward(cfg, p["mixer"], h, mode=mode,
                           cache=cache["ssm"] if cache else None)
    else:
        raise ValueError(mixer)
    x = x + y
    if "cross" in p:
        h = rmsnorm(x, p["cross_norm"], cfg.norm_eps)
        if mode == "decode":
            kv = (cache["cross"]["ck"], cache["cross"]["cv"])
        else:
            kv = (torch.einsum("bsd,dhk->bshk", enc_out, p["cross"]["wk"]),
                  torch.einsum("bsd,dhk->bshk", enc_out, p["cross"]["wv"]))
            if mode == "prefill":
                cache["cross"]["ck"].copy_(kv[0])
                cache["cross"]["cv"].copy_(kv[1])
        y, _ = attn_forward(cfg, p["cross"], h, positions=positions, mode=mode,
                            pos=pos, kv_override=kv, causal=False)
        x = x + y
    ff = cfg.ff_at(layer_idx)
    stats = None
    if ff != FF_NONE:
        h = rmsnorm(x, p["ff_norm"], cfg.norm_eps)
        if ff == FF_MOE:
            y, stats = moe_layer(cfg, p["ff"], h)
        else:
            y = apply_ffn(p["ff"], h, ff)
        x = x + y
    return x, cache, stats


def _layer(cfg: ModelConfig, p: dict, x, layer_idx: int, **kw):
    """``apply_layer`` inside a ``model.layer`` span; under a train-mode
    checkpoint the span opens in the forward and again in the recompute."""
    with span("model.layer"):
        return apply_layer(cfg, p, x, layer_idx, **kw)


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


def decoder(cfg: ModelConfig, dparams: dict, x, *, positions, mode: str = "train",
            cache: Optional[dict] = None, pos: Optional[int] = None, enc_out=None):
    """(x, cache, [(psum, counts) of each MoE layer, in layer order]).
    Prefill and decode take the cache of ``model.make_cache`` and write it
    in place.  ``enc_out``: the encoder's output, which every layer's cross
    block attends to in train and prefill (decode reads the cross cache);
    in train mode it is an argument of each layer's checkpoint, so the
    encoder's gradients flow back through it."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    prefix, n = cfg.scan_layers()
    period = cfg.layer_period()
    n_blocks = n // period
    layers = [(i, dparams["prefix"][f"layer{i}"],
               cache["prefix"][f"layer{i}"] if cache else None) for i in range(prefix)]
    if n:
        subs = []                   # (layer index, per-block params, per-block caches)
        for j in range(period):
            name = f"sub{j}"
            caches = (_split_layers(cache["blocks"][name], n_blocks) if cache
                      else [None] * n_blocks)
            subs.append((prefix + j, _split_layers(dparams["blocks"][name], n_blocks),
                         caches))
        layers += [(i, lps[b], cs[b]) for b in range(n_blocks) for i, lps, cs in subs]
    moe_stats = []
    for i, lp, c in layers:
        if mode == "train":
            x, _, stats = checkpoint(_layer, cfg, lp, x, i, positions=positions,
                                     enc_out=enc_out, use_reentrant=False)
        else:
            x, _, stats = _layer(cfg, lp, x, i, positions=positions,
                                 mode=mode, cache=c, pos=pos, enc_out=enc_out)
        if stats is not None:
            moe_stats.append(stats)
    return x, cache, moe_stats


def encoder_layer(cfg: ModelConfig, p: dict, x, positions):
    """RMSNorm -> bidirectional self-attention (RoPE on q and k, the blocked
    twin) -> residual -> RMSNorm -> dense FFN -> residual."""
    h = rmsnorm(x, p["mixer_norm"], cfg.norm_eps)
    y, _ = attn_forward(cfg, p["mixer"], h, positions=positions, mode="train",
                        causal=False)
    x = x + y
    h = rmsnorm(x, p["ff_norm"], cfg.norm_eps)
    return x + apply_ffn(p["ff"], h, cfg.ff_kind)


def encoder(cfg: ModelConfig, eparams: dict, x, *, positions, mode: str = "train"):
    """The encoder stack (counterpart of the reference's ``encoder``) over
    frame embeddings x (B, S_enc, D): the stacked ``encoder/blocks`` split
    into per-layer leaves by ``_split_layers``, each layer under its own
    checkpoint in train mode, then the final RMSNorm.  Its attention runs
    in train mode whatever ``mode`` is, as the reference's does: the
    encoder never touches a cache."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    for lp in _split_layers(eparams["blocks"], cfg.enc_layers):
        if mode == "train":
            x = checkpoint(encoder_layer, cfg, lp, x, positions, use_reentrant=False)
        else:
            x = encoder_layer(cfg, lp, x, positions)
    return rmsnorm(x, eparams["final_norm"], cfg.norm_eps)
