"""Public model API of the port (counterpart of ``repro.models.model``, the
training forward of the dense and Mamba-2 decoders).

Batch convention: ``tokens`` and ``labels`` are (B, S) integer tensors on the
parameters' device, label -1 = masked.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import chunked_softmax_xent, rmsnorm
from repro_torch.models.params import (from_numpy_flat, init_params,
                                       param_count, param_shapes, param_specs,
                                       to_numpy_flat)

LOSS_CHUNK = 512


def forward_hidden(cfg: ModelConfig, params, batch):
    """Embeds and runs the decoder; returns the final-normed hidden (B,S,D)."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = params["embed"][tokens]
    x = tfm.decoder(cfg, params["decoder"], x, positions=positions)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps)


def _head_weight(cfg: ModelConfig, params):
    if cfg.tie_embeddings:
        return params["embed"].T          # (D, V)
    return params["lm_head"]


def loss_terms(cfg: ModelConfig, params, batch):
    """(loss_sum, weight) of the batch: summed token cross-entropy and the
    number of unmasked labels, so shards combine as sum/sum."""
    hidden = forward_hidden(cfg, params, batch)
    return chunked_softmax_xent(hidden, _head_weight(cfg, params),
                                batch["labels"],
                                chunk=min(LOSS_CHUNK, hidden.shape[1]),
                                valid_vocab=cfg.vocab_size)


def loss_fn(cfg: ModelConfig, params, batch) -> Tuple[torch.Tensor, dict]:
    """(loss, {"loss","xent","aux","tokens"}); neither family has an aux
    loss."""
    loss_sum, weight = loss_terms(cfg, params, batch)
    xent = loss_sum / torch.clamp(weight, min=1.0)
    aux = torch.zeros((), dtype=torch.float32, device=xent.device)
    loss = xent + aux
    return loss, {"loss": loss, "xent": xent, "aux": aux, "tokens": weight}


__all__ = ["forward_hidden", "loss_terms", "loss_fn", "init_params",
           "param_specs", "param_shapes", "param_count", "from_numpy_flat",
           "to_numpy_flat", "LOSS_CHUNK"]
