"""Public model API of the port (counterpart of ``repro.models.model``, the
training forward of the decoders the port builds).

Batch convention: ``tokens`` and ``labels`` are (B, S) integer tensors on the
parameters' device, label -1 = masked.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.configs.base import (ModelConfig, count_active_params,
                                      count_params)
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import chunked_softmax_xent, rmsnorm
from repro_torch.models.moe import balance_loss
from repro_torch.models.params import (from_numpy_flat, init_params,
                                       param_count, param_shapes, param_specs,
                                       to_numpy_flat)

LOSS_CHUNK = 512


def forward_hidden(cfg: ModelConfig, params, batch):
    """Embeds and runs the decoder; returns (the final-normed hidden (B,S,D),
    the MoE layers' ``balance_stats`` sums)."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = params["embed"][tokens]
    x, moe_stats = tfm.decoder(cfg, params["decoder"], x, positions=positions)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), moe_stats


def _head_weight(cfg: ModelConfig, params):
    if cfg.tie_embeddings:
        return params["embed"].T          # (D, V)
    return params["lm_head"]


def loss_terms(cfg: ModelConfig, params, batch):
    """(loss_sum, weight, moe_stats) of the batch: summed token cross-entropy,
    the number of unmasked labels and each MoE layer's (psum, counts), so
    shards combine as sum/sum and their aux loss as one global batch's."""
    hidden, moe_stats = forward_hidden(cfg, params, batch)
    loss_sum, weight = chunked_softmax_xent(
        hidden, _head_weight(cfg, params), batch["labels"],
        chunk=min(LOSS_CHUNK, hidden.shape[1]), valid_vocab=cfg.vocab_size)
    return loss_sum, weight, moe_stats


def aux_loss(cfg: ModelConfig, moe_stats: Sequence, n_tokens: int,
             device=None) -> torch.Tensor:
    """The MoE load-balance loss over ``n_tokens`` tokens, summed over the
    layers, each weighted by ``router_aux_weight``; 0 without MoE layers."""
    aux = torch.zeros((), dtype=torch.float32, device=device)
    for psum, counts in moe_stats:
        aux = aux + balance_loss(psum, counts, n_tokens,
                                 cfg.moe.num_experts) * cfg.moe.router_aux_weight
    return aux


def loss_fn(cfg: ModelConfig, params, batch) -> Tuple[torch.Tensor, dict]:
    """(loss, {"loss","xent","aux","tokens"}): loss = xent + aux."""
    loss_sum, weight, moe_stats = loss_terms(cfg, params, batch)
    xent = loss_sum / torch.clamp(weight, min=1.0)
    aux = aux_loss(cfg, moe_stats, batch["tokens"].numel(), xent.device)
    loss = xent + aux
    return loss, {"loss": loss, "xent": xent, "aux": aux, "tokens": weight}


__all__ = ["forward_hidden", "loss_terms", "aux_loss", "loss_fn", "init_params",
           "param_specs", "param_shapes", "param_count", "count_params",
           "count_active_params", "from_numpy_flat", "to_numpy_flat",
           "LOSS_CHUNK"]
