"""Decoder stack (counterpart of ``repro.models.transformer``): each layer's
mixer is attention or the Mamba-2 SSD block, and its FFN SwiGLU or none, as
``cfg.mixer_at`` / ``cfg.ff_at`` say.

Block parameters are stacked with a leading layer axis
(``decoder/blocks/sub0/...``) as the reference scans them.  Each layer runs
under ``torch.utils.checkpoint(use_reentrant=False)``, the counterpart of the
reference's remat policy "full": only the residual stream is kept between
layers and the layer is recomputed in the backward.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, FF_NONE, SSM, ModelConfig
from repro_torch.models.attention import attn_forward
from repro_torch.models.layers import apply_ffn, rmsnorm
from repro_torch.models.ssm import ssm_forward


def apply_layer(cfg: ModelConfig, p: dict, x, layer_idx: int, *, positions):
    """RMSNorm -> mixer -> residual [-> RMSNorm -> FFN -> residual]."""
    mixer = cfg.mixer_at(layer_idx)
    h = rmsnorm(x, p["mixer_norm"], cfg.norm_eps)
    if mixer == ATTN:
        x = x + attn_forward(cfg, p["mixer"], h, positions=positions)
    elif mixer == SSM:
        x = x + ssm_forward(cfg, p["mixer"], h)
    else:
        raise ValueError(mixer)
    ff = cfg.ff_at(layer_idx)
    if ff != FF_NONE:
        h = rmsnorm(x, p["ff_norm"], cfg.norm_eps)
        x = x + apply_ffn(p["ff"], h, ff)
    return x


def _unbind_layers(tree, n: int):
    """Stacked {leaf: (L, ...)} tree -> list of L per-layer trees (views)."""
    if isinstance(tree, dict):
        per = {k: _unbind_layers(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def decoder(cfg: ModelConfig, dparams: dict, x, *, positions):
    prefix, n = cfg.scan_layers()
    for lp in _unbind_layers(dparams["blocks"]["sub0"], n):
        x = checkpoint(apply_layer, cfg, lp, x, prefix, positions=positions,
                       use_reentrant=False)
    return x
