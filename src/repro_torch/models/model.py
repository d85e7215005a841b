"""Public model API of the port (counterpart of ``repro.models.model``) for
every layout of the JAX package, decoders and the encoder-decoder:

- ``loss_fn`` / ``forward_hidden``: the training forward;
- ``make_cache``, ``prefill``, ``pad_cache`` and ``decode_step``: serving, a
  batched prefill of a prompt, then one token for the whole batch at a time
  against a fixed-size cache, written in place.

Batch convention: ``tokens`` and ``labels`` are (B, S) integer tensors on the
parameters' device, label -1 = masked; an encoder-decoder model adds
``enc_embeds`` (B, S_enc, d_model), the audio frontend stub's frames, cast
to the parameters' dtype on entry.  Decode: tokens (B, 1), an int
``pos`` and the cache, whose keys, shapes and dtypes are those of
``repro.checkpoint.reshard.flatten_tree`` of the reference's cache.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.checkpoint.reshard import flatten_tree, nest_flat
from repro_torch.configs.base import (ATTN, MLA, SSM, ModelConfig, ShapeConfig,
                                      count_active_params, count_params)
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import init_kv_cache, init_mla_cache
from repro_torch.models.layers import chunked_softmax_xent, rmsnorm
from repro_torch.models.moe import balance_loss
from repro_torch.models.params import (abstract_params, from_numpy_flat,
                                       init_params, logical_axes, param_count,
                                       param_shapes, param_specs, to_numpy_flat)
from repro_torch.models.ssm import init_ssm_cache

LOSS_CHUNK = 512


def _encode(cfg: ModelConfig, params, batch, mode: str):
    """The encoder's output over ``batch["enc_embeds"]`` cast to the
    parameters' dtype, or None for a model without an encoder."""
    if not cfg.enc_layers:
        return None
    enc_in = batch["enc_embeds"].to(params["embed"].dtype)
    positions = torch.arange(enc_in.shape[1], device=enc_in.device)
    return tfm.encoder(cfg, params["encoder"], enc_in, positions=positions, mode=mode)


def forward_hidden(cfg: ModelConfig, params, batch):
    """Embeds and runs the encoder (if any) and the decoder; returns (the
    final-normed hidden (B,S,D), the MoE layers' ``balance_stats`` sums)."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    enc_out = _encode(cfg, params, batch, "train")
    x = params["embed"][tokens]
    x, _, moe_stats = tfm.decoder(cfg, params["decoder"], x, positions=positions,
                                  enc_out=enc_out)
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


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _layer_cache(cfg: ModelConfig, i: int, batch: int, max_len: int, dtype,
                 device, enc_len: int) -> dict:
    mixer = cfg.mixer_at(i)
    if mixer == ATTN:
        c = {"kv": init_kv_cache(cfg, batch, max_len, dtype, device)}
    elif mixer == MLA:
        c = {"kv": init_mla_cache(cfg, batch, max_len, dtype, device)}
    elif mixer == SSM:
        c = {"ssm": init_ssm_cache(cfg, batch, dtype, device)}
    else:
        raise ValueError(mixer)
    if cfg.enc_layers:
        cross = init_kv_cache(cfg, batch, enc_len, dtype, device)
        c["cross"] = {"ck": cross["k"], "cv": cross["v"]}
    return c


def make_cache(cfg: ModelConfig, batch: int, max_len: int, *, enc_len: int = 0,
               dtype=None, device="cuda") -> dict:
    """A zeroed cache for ``batch`` sequences of up to ``max_len`` tokens:
    ``{"prefix": {"layer{i}": layer cache}, "blocks": {"sub{j}": layer
    ``prefix + j``'s cache with a leading block axis}}``, each part present
    where the model has such layers (a hybrid block holds both kinds); a
    layer cache is ``{"kv": {"k", "v"}}`` (GQA), ``{"kv": {"ckv",
    "krope"}}`` (MLA) or ``{"ssm": {"conv", "h"}}``, and in an
    encoder-decoder model also ``{"cross": {"ck", "cv"}}``, the encoder's
    projected keys and values, (batch, ``enc_len``, kv heads, head dim);
    ``h`` is float32, the rest ``dtype`` (the model's by default).
    ``device="meta"`` gives the dry-run's cache (the reference's
    ``abstract=True``), which allocates nothing."""
    prefix, n = cfg.scan_layers()
    period = cfg.layer_period()
    dtype = dtype or getattr(torch, cfg.dtype)
    cache = {}
    if prefix:
        cache["prefix"] = {f"layer{i}": _layer_cache(cfg, i, batch, max_len, dtype,
                                                     device, enc_len)
                           for i in range(prefix)}
    if n:
        cache["blocks"] = {}
        for j in range(period):
            layer = _layer_cache(cfg, prefix + j, batch, max_len, dtype, device, enc_len)
            cache["blocks"][f"sub{j}"] = nest_flat(
                {k: t.expand(n // period, *t.shape).contiguous()
                 for k, t in flatten_tree(layer).items()})
    return cache


def _layer_cache_axes(cfg: ModelConfig, i: int) -> dict:
    """Logical axes mirroring ``_layer_cache`` (for dry-run input shardings)."""
    mixer = cfg.mixer_at(i)
    c = {}
    if mixer == ATTN:
        kv = ("cache_batch", "cache_seq", "kv_heads", None)
        c["kv"] = {"k": kv, "v": kv}
    elif mixer == MLA:
        c["kv"] = {"ckv": ("cache_batch", "cache_seq", None),
                   "krope": ("cache_batch", "cache_seq", None)}
    elif mixer == SSM:
        c["ssm"] = {"conv": ("cache_batch", None, "ssm_inner"),
                    "h": ("cache_batch", "ssm_heads", None, None)}
    if cfg.enc_layers:
        kv = ("cache_batch", None, "kv_heads", None)
        c["cross"] = {"ck": kv, "cv": kv}
    return c


def cache_axes(cfg: ModelConfig) -> dict:
    """Logical-axis tree matching ``make_cache``'s structure."""
    prefix, n = cfg.scan_layers()
    period = cfg.layer_period()
    axes = {}
    if prefix:
        axes["prefix"] = {f"layer{i}": _layer_cache_axes(cfg, i)
                          for i in range(prefix)}
    if n:
        axes["blocks"] = {
            f"sub{j}": nest_flat({k: ("layers",) + a for k, a in
                                  flatten_tree(_layer_cache_axes(cfg, prefix + j)).items()})
            for j in range(period)}
    return axes


@torch.inference_mode()
def prefill(cfg: ModelConfig, params, batch):
    """Run the prompt (and, in an encoder-decoder model, the encoder over
    ``batch["enc_embeds"]``, whose projected keys and values each layer
    writes into its cross cache); returns (cache at the prompt's length,
    last-token logits[:, :vocab_size] in float32).  The cache is allocated
    once, stacked, and each layer writes its slice; the caller pads it to
    the serving window (``pad_cache``) before ``decode_step``."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    enc_out = _encode(cfg, params, batch, "prefill")
    cache = make_cache(cfg, B, S, enc_len=0 if enc_out is None else enc_out.shape[1],
                       dtype=params["embed"].dtype, device=tokens.device)
    positions = torch.arange(S, device=tokens.device)
    x = params["embed"][tokens]
    x, cache, _ = tfm.decoder(cfg, params["decoder"], x, positions=positions,
                              mode="prefill", cache=cache, pos=0, enc_out=enc_out)
    x = rmsnorm(x[:, -1], params["final_norm"], cfg.norm_eps)   # row-wise
    logits = torch.matmul(x, _head_weight(cfg, params))
    return cache, logits[:, :cfg.vocab_size].float()


@torch.inference_mode()
def decode_step(cfg: ModelConfig, params, cache, tokens, pos: int):
    """One decode step: tokens (B, 1), ``pos`` the tokens already in the
    cache.  Returns (logits (B, vocab_size) float32, cache).

    Unlike the reference, which returns a new cache pytree, this writes the
    new token's keys and values (or conv window and state) into ``cache`` in
    place and returns that same cache: a copy of yi-6b's 2.2 GB cache each
    step would cost more than the step.  An encoder-decoder model's cross
    blocks read the cross cache prefill wrote; the encoder does not run."""
    positions = torch.arange(pos, pos + tokens.shape[1], device=tokens.device)
    x = params["embed"][tokens]
    x, cache, _ = tfm.decoder(cfg, params["decoder"], x, positions=positions,
                              mode="decode", cache=cache, pos=pos)
    x = rmsnorm(x[:, 0], params["final_norm"], cfg.norm_eps)
    logits = torch.matmul(x, _head_weight(cfg, params))
    return logits[:, :cfg.vocab_size].float(), cache


@torch.inference_mode()
def pad_cache(cfg: ModelConfig, cache, prompt_len: int, max_len: int):
    """Grow prefill KV caches (sequence axis == prompt_len) to the serving
    window, as the reference does: only leaves under a ``kv`` key are padded,
    at the end of the sequence axis, which is 2 under ``blocks`` (axis 0 is
    the stacked layers) and 1 elsewhere (the prefix layers), whatever the
    leaf's rank; SSM states, conv windows and the cross cache (``cross``)
    are returned as they are."""
    if max_len == prompt_len:
        return cache
    flat = flatten_tree(cache)
    for key, t in flat.items():
        names = key.split("/")
        axis = 2 if "blocks" in names else 1
        if "kv" in names and t.shape[axis] == prompt_len:
            flat[key] = F.pad(t, (0, 0) * (t.dim() - 1 - axis) + (0, max_len - prompt_len))
    return nest_flat(flat)


# ---------------------------------------------------------------------------
# Dry-run input specs
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta-tensor stand-ins for every model input of this cell.  Tokens and
    labels are ``torch.long``, the dtype the port's entry points take, where
    the reference's are int32; the encoder's frames are the model's dtype."""
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    meta = lambda shp, dtype: torch.empty(shp, dtype=dtype, device="meta")
    if shape.kind in ("train", "prefill"):
        spec = {"tokens": meta((B, S), torch.long)}
        if shape.kind == "train":
            spec["labels"] = meta((B, S), torch.long)
        if cfg.enc_layers:
            spec["enc_embeds"] = meta((B, S, cfg.d_model), dt)
        return spec
    if shape.kind != "decode":
        raise ValueError(f"unknown shape kind {shape.kind!r}")
    return {
        "tokens": meta((B, 1), torch.long),
        "pos": meta((), torch.int32),
        "cache": make_cache(cfg, B, S, enc_len=S if cfg.enc_layers else 0,
                            device="meta"),
    }


__all__ = ["forward_hidden", "loss_terms", "aux_loss", "loss_fn", "init_params",
           "param_specs", "param_shapes", "param_count", "count_params",
           "count_active_params", "from_numpy_flat", "to_numpy_flat",
           "make_cache", "prefill", "decode_step", "pad_cache", "LOSS_CHUNK",
           "abstract_params", "logical_axes", "cache_axes", "input_specs"]
