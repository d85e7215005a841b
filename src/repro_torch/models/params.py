"""Parameter specs and initialisation (counterpart of
``repro.models.params`` for every layout of the JAX package: GQA attention
with or without ``qk_norm``, DeepSeek-V2 MLA, SwiGLU, GELU, squared-ReLU or
MoE FFNs, and Mamba-2, alone or mixed in one period as jamba mixes them; the
prefix layers (``first_dense``, and a depth's remainder modulo the layer
period) unstacked at ``decoder/prefix/layer{i}``, the rest stacked in blocks
of one period, ``decoder/blocks/sub{j}`` for j < ``cfg.layer_period()``; an
encoder-decoder model adds a cross-attention block (``cross_norm``,
``cross``) to every decoder layer and a bidirectional encoder, its layers
stacked at ``encoder/blocks`` beside ``encoder/final_norm``).

Shapes and the ``/``-joined flat keys equal
``repro.checkpoint.reshard.flatten_tree(repro.models.params.init_params(cfg,
key))``; the distributions equal the reference's (``normal`` scaled by
``1/sqrt(fan_in)``, norms and ``d_skip`` at one, the Mamba-2 ``a_log``,
``dt_bias`` and conv inits), and each leaf's logical axes equal the
reference's.  The bits differ, since a ``torch.Generator`` is
not ``jax.random``: parity tests carry the reference's parameters across with
``from_numpy_flat``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint.reshard import (host_tensor, nest_flat,
                                            snapshot_to_host, tree_map,
                                            tree_path_keys, unflatten_tree)
from repro_torch.configs.base import (ATTN, FF_GELU, FF_MOE, FF_NONE, FF_RELU2,
                                      FF_SWIGLU, MLA, SSM, ModelConfig)
from repro_torch.device import resolve_device
from repro_torch.models.ssm import _dims


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis names, len == len(shape)
    init: str = "normal"    # normal | ones | zeros | ssm_a | dt_bias | uniform_conv
    fan_in: int = 0         # 0 => shape[0]

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def _attn_specs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    s = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "qk")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "qk")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "qk")),
        "wo": ParamSpec((h, hd, d), ("heads", "qk", "embed"), fan_in=h * hd),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((hd,), (None,), "ones")
        s["k_norm"] = ParamSpec((hd,), (None,), "ones")
    return s


def _mla_specs(cfg: ModelConfig) -> dict:
    a, d, h = cfg.mla, cfg.d_model, cfg.num_heads
    qk_dim = a.qk_nope_head_dim + a.qk_rope_head_dim
    s = {}
    if a.q_lora_rank:
        s["wq_a"] = ParamSpec((d, a.q_lora_rank), ("embed", "lora"))
        s["q_norm"] = ParamSpec((a.q_lora_rank,), (None,), "ones")
        s["wq_b"] = ParamSpec((a.q_lora_rank, h, qk_dim), ("lora", "heads", "qk"),
                              fan_in=a.q_lora_rank)
    else:
        s["wq"] = ParamSpec((d, h, qk_dim), ("embed", "heads", "qk"))
    # kv down-projection also produces the shared rope key
    s["wkv_a"] = ParamSpec((d, a.kv_lora_rank + a.qk_rope_head_dim),
                           ("embed", "lora"))
    s["kv_norm"] = ParamSpec((a.kv_lora_rank,), (None,), "ones")
    s["wkv_b"] = ParamSpec((a.kv_lora_rank, h, a.qk_nope_head_dim + a.v_head_dim),
                           ("lora", "heads", "qk"), fan_in=a.kv_lora_rank)
    s["wo"] = ParamSpec((h, a.v_head_dim, d), ("heads", "qk", "embed"),
                        fan_in=h * a.v_head_dim)
    return s


def _ssm_specs(cfg: ModelConfig) -> dict:
    ss, d_inner, nh, gn, conv_dim = _dims(cfg)
    d = cfg.d_model
    return {
        # in_proj -> [z (d_inner), x (d_inner), B (gn), C (gn), dt (nh)]
        "in_proj": ParamSpec((d, 2 * d_inner + 2 * gn + nh), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((ss.conv_width, conv_dim), (None, "ssm_inner"),
                            "uniform_conv", fan_in=ss.conv_width),
        "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), "zeros"),
        "a_log": ParamSpec((nh,), ("ssm_heads",), "ssm_a"),
        "d_skip": ParamSpec((nh,), ("ssm_heads",), "ones"),
        "dt_bias": ParamSpec((nh,), ("ssm_heads",), "dt_bias"),
        "out_norm": ParamSpec((d_inner,), ("ssm_inner",), "ones"),
        "out_proj": ParamSpec((d_inner, d), ("ssm_inner", "embed"), fan_in=d_inner),
    }


def _ffn_specs(cfg: ModelConfig, kind: str, d_ff: int) -> dict:
    d = cfg.d_model
    if kind == FF_SWIGLU:
        return {
            "w_gate": ParamSpec((d, d_ff), ("embed", "ffn")),
            "w_up": ParamSpec((d, d_ff), ("embed", "ffn")),
            "w_down": ParamSpec((d_ff, d), ("ffn", "embed"), fan_in=d_ff),
        }
    if kind in (FF_GELU, FF_RELU2):
        return {
            "w_up": ParamSpec((d, d_ff), ("embed", "ffn")),
            "w_down": ParamSpec((d_ff, d), ("ffn", "embed"), fan_in=d_ff),
        }
    raise ValueError(kind)


def _moe_specs(cfg: ModelConfig) -> dict:
    """Router (d, E) and experts stacked (E, d, f) / (E, f, d)."""
    m, d = cfg.moe, cfg.d_model
    e, f = m.num_experts, m.d_ff_expert
    s = {"router": ParamSpec((d, e), ("embed", "experts"))}
    if m.ff_kind == FF_SWIGLU:
        s["w_gate"] = ParamSpec((e, d, f), ("experts", "embed", "expert_ffn"), fan_in=d)
    s["w_up"] = ParamSpec((e, d, f), ("experts", "embed", "expert_ffn"), fan_in=d)
    s["w_down"] = ParamSpec((e, f, d), ("experts", "expert_ffn", "embed"), fan_in=f)
    if m.num_shared_experts:
        s["shared"] = _ffn_specs(cfg, m.ff_kind, m.num_shared_experts * m.d_ff_expert)
    return s


def _layer_specs(cfg: ModelConfig, i: int, *, cross_attn: bool = False) -> dict:
    d = cfg.d_model
    mixer = cfg.mixer_at(i)
    s = {"mixer_norm": ParamSpec((d,), ("embed",), "ones")}
    if mixer == ATTN:
        s["mixer"] = _attn_specs(cfg)
    elif mixer == MLA:
        s["mixer"] = _mla_specs(cfg)
    elif mixer == SSM:
        s["mixer"] = _ssm_specs(cfg)
    else:
        raise ValueError(mixer)
    if cross_attn:
        s["cross_norm"] = ParamSpec((d,), ("embed",), "ones")
        s["cross"] = _attn_specs(cfg)
    ff = cfg.ff_at(i)
    if ff != FF_NONE:
        s["ff_norm"] = ParamSpec((d,), ("embed",), "ones")
        s["ff"] = _moe_specs(cfg) if ff == FF_MOE else _ffn_specs(cfg, ff, cfg.d_ff)
    return s


def _stack(tree, n: int):
    """Prefix every leaf spec with a stacked 'layers' axis of length n."""
    if isinstance(tree, dict):
        return {k: _stack(v, n) for k, v in tree.items()}
    return ParamSpec((n,) + tree.shape, ("layers",) + tree.axes, tree.init,
                     tree.fan_in or tree.shape[0])


def _decoder_specs(cfg: ModelConfig, *, cross_attn: bool) -> dict:
    """The prefix layers unstacked; the rest in blocks of one layer period,
    sub-layer j of every block stacked on a leading block axis as
    ``sub{j}``, built as layer ``prefix + j`` (the index that picks its
    mixer and FFN).  A depth with no stacked layers has no ``blocks``."""
    prefix, n = cfg.scan_layers()
    period = cfg.layer_period()
    s = {}
    if prefix:
        s["prefix"] = {f"layer{i}": _layer_specs(cfg, i, cross_attn=cross_attn)
                       for i in range(prefix)}
    if n:
        s["blocks"] = {f"sub{j}": _stack(_layer_specs(cfg, prefix + j,
                                                      cross_attn=cross_attn),
                                         n // period)
                       for j in range(period)}
    return s


def _encoder_layer_specs(cfg: ModelConfig) -> dict:
    """Encoder layer: bidirectional self-attention + dense FFN."""
    d = cfg.d_model
    return {
        "mixer_norm": ParamSpec((d,), ("embed",), "ones"),
        "mixer": _attn_specs(cfg),
        "ff_norm": ParamSpec((d,), ("embed",), "ones"),
        "ff": _ffn_specs(cfg, cfg.ff_kind, cfg.d_ff),
    }


def param_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    s = {
        "embed": ParamSpec((cfg.padded_vocab, d), ("vocab", "embed"), fan_in=d),
        "final_norm": ParamSpec((d,), ("embed",), "ones"),
        "decoder": _decoder_specs(cfg, cross_attn=cfg.enc_layers > 0),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((d, cfg.padded_vocab), ("embed", "vocab"))
    if cfg.enc_layers:
        s["encoder"] = {"blocks": _stack(_encoder_layer_specs(cfg), cfg.enc_layers),
                        "final_norm": ParamSpec((d,), ("embed",), "ones")}
    return s


def _init_leaf(spec: ParamSpec, gen: torch.Generator, dtype, device):
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    t = torch.empty(spec.shape, dtype=torch.float32, device=device)
    fan = spec.fan_in or spec.shape[0]
    if spec.init == "ssm_a":
        # A in [1, 16) -> a_log = log(A); standard mamba2 init
        t.uniform_(1.0, 16.0, generator=gen).log_()
    elif spec.init == "dt_bias":
        # dt in [1e-3, 1e-1] -> bias = softplus^-1(dt)
        t.uniform_(math.log(1e-3), math.log(1e-1), generator=gen).exp_()
        t = t + torch.log(-torch.expm1(-t))
    elif spec.init == "uniform_conv":
        lim = 1.0 / math.sqrt(fan)
        t.uniform_(-lim, lim, generator=gen)
    elif spec.init == "normal":
        t.normal_(generator=gen).mul_(1.0 / math.sqrt(fan))
    else:
        raise ValueError(spec.init)
    return t.to(dtype)


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Union[str, torch.device] = "cuda") -> dict:
    """Fresh parameters on ``device`` (leaves with ``requires_grad``), drawn
    leaf by leaf in flat-key order from one generator seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    specs = param_specs(cfg)
    leaves = {k: _init_leaf(s, gen, dtype, dev).requires_grad_()
              for k, s in tree_path_keys(specs)}
    return unflatten_tree(specs, leaves)


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as meta tensors of the model's dtype (the dry-run's
    stand-in for the reference's ShapeDtypeStruct tree; allocates nothing)."""
    dtype = getattr(torch, cfg.dtype)
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"),
                    param_specs(cfg))


def logical_axes(cfg: ModelConfig) -> dict:
    """The parameter tree's logical axes, one tuple a leaf."""
    return tree_map(lambda s: s.axes, param_specs(cfg))


def param_shapes(cfg: ModelConfig) -> dict:
    """{flat key: shape} of every parameter."""
    return {k: s.shape for k, s in tree_path_keys(param_specs(cfg))}


def param_count(cfg: ModelConfig) -> int:
    return sum(int(np.prod(s)) for s in param_shapes(cfg).values())


def from_numpy_flat(flat: dict, device: Union[str, torch.device] = "cuda", *,
                    requires_grad: Optional[bool] = None) -> dict:
    """``{flatten_tree key: ndarray}`` (the JAX package's parameters or AdamW
    state, as numpy) -> the port's nested tree of tensors on ``device``.

    A 2-byte void array (an ``ml_dtypes.bfloat16`` array of the JAX package,
    or a ``V2`` array read back from an npz file) becomes a bfloat16 tensor
    of the same bits; no other void dtype is accepted.  Floating leaves get
    ``requires_grad`` unless told otherwise."""
    dev = resolve_device(device)

    def put(a):
        t = host_tensor(np.array(a, copy=True)).to(dev)
        rg = t.is_floating_point() if requires_grad is None else requires_grad
        return t.requires_grad_(rg and t.is_floating_point())
    return nest_flat({k: put(v) for k, v in flat.items()})


def to_numpy_flat(tree) -> dict:
    """The port's tree -> ``{flatten_tree key: ndarray}`` (copies)."""
    return snapshot_to_host(tree)
