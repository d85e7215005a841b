"""Parameter specs and initialisation (counterpart of
``repro.models.params`` for the decoders the port builds: GQA attention with
or without ``qk_norm``, SwiGLU, GELU, squared-ReLU or MoE FFNs, and Mamba-2).

Shapes and the ``/``-joined flat keys equal
``repro.checkpoint.reshard.flatten_tree(repro.models.params.init_params(cfg,
key))``; the distributions equal the reference's (``normal`` scaled by
``1/sqrt(fan_in)``, norms and ``d_skip`` at one, the Mamba-2 ``a_log``,
``dt_bias`` and conv inits).  The bits differ, since a ``torch.Generator`` is
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
                                            snapshot_to_host,
                                            tree_path_keys, unflatten_tree)
from repro_torch.configs.base import (ATTN, FF_GELU, FF_MOE, FF_NONE, FF_RELU2,
                                      FF_SWIGLU, SSM, ModelConfig)
from repro_torch.device import resolve_device
from repro_torch.models.ssm import _dims


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"    # normal | ones | zeros | ssm_a | dt_bias | uniform_conv
    fan_in: int = 0         # 0 => shape[0]


def _attn_specs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    s = {
        "wq": ParamSpec((d, h, hd)),
        "wk": ParamSpec((d, kv, hd)),
        "wv": ParamSpec((d, kv, hd)),
        "wo": ParamSpec((h, hd, d), fan_in=h * hd),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((hd,), "ones")
        s["k_norm"] = ParamSpec((hd,), "ones")
    return s


def _ssm_specs(cfg: ModelConfig) -> dict:
    ss, d_inner, nh, gn, conv_dim = _dims(cfg)
    d = cfg.d_model
    return {
        # in_proj -> [z (d_inner), x (d_inner), B (gn), C (gn), dt (nh)]
        "in_proj": ParamSpec((d, 2 * d_inner + 2 * gn + nh)),
        "conv_w": ParamSpec((ss.conv_width, conv_dim), "uniform_conv",
                            fan_in=ss.conv_width),
        "conv_b": ParamSpec((conv_dim,), "zeros"),
        "a_log": ParamSpec((nh,), "ssm_a"),
        "d_skip": ParamSpec((nh,), "ones"),
        "dt_bias": ParamSpec((nh,), "dt_bias"),
        "out_norm": ParamSpec((d_inner,), "ones"),
        "out_proj": ParamSpec((d_inner, d), fan_in=d_inner),
    }


def _ffn_specs(cfg: ModelConfig, kind: str, d_ff: int) -> dict:
    d = cfg.d_model
    if kind == FF_SWIGLU:
        return {
            "w_gate": ParamSpec((d, d_ff)),
            "w_up": ParamSpec((d, d_ff)),
            "w_down": ParamSpec((d_ff, d), fan_in=d_ff),
        }
    if kind in (FF_GELU, FF_RELU2):
        return {
            "w_up": ParamSpec((d, d_ff)),
            "w_down": ParamSpec((d_ff, d), fan_in=d_ff),
        }
    raise ValueError(kind)


def _moe_specs(cfg: ModelConfig) -> dict:
    """Router (d, E) and experts stacked (E, d, f) / (E, f, d)."""
    m, d = cfg.moe, cfg.d_model
    e, f = m.num_experts, m.d_ff_expert
    s = {"router": ParamSpec((d, e))}
    if m.ff_kind == FF_SWIGLU:
        s["w_gate"] = ParamSpec((e, d, f), fan_in=d)
    s["w_up"] = ParamSpec((e, d, f), fan_in=d)
    s["w_down"] = ParamSpec((e, f, d), fan_in=f)
    if m.num_shared_experts:
        s["shared"] = _ffn_specs(cfg, m.ff_kind, m.num_shared_experts * m.d_ff_expert)
    return s


def _layer_specs(cfg: ModelConfig, i: int) -> dict:
    d = cfg.d_model
    mixer = cfg.mixer_at(i)
    s = {"mixer_norm": ParamSpec((d,), "ones")}
    if mixer == ATTN:
        s["mixer"] = _attn_specs(cfg)
    elif mixer == SSM:
        s["mixer"] = _ssm_specs(cfg)
    else:
        raise ValueError(mixer)
    ff = cfg.ff_at(i)
    if ff != FF_NONE:
        s["ff_norm"] = ParamSpec((d,), "ones")
        s["ff"] = _moe_specs(cfg) if ff == FF_MOE else _ffn_specs(cfg, ff, cfg.d_ff)
    return s


def _stack(tree, n: int):
    """Prefix every leaf spec with a stacked 'layers' axis of length n."""
    if isinstance(tree, dict):
        return {k: _stack(v, n) for k, v in tree.items()}
    return ParamSpec((n,) + tree.shape, tree.init, tree.fan_in or tree.shape[0])


def _refuse_unported(cfg: ModelConfig) -> None:
    """Layouts whose family is not ported yet, each with its ROADMAP item."""
    if cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: multi-head latent attention waits for ROADMAP A.4(d)")
    if cfg.scan_layers()[0]:
        raise NotImplementedError(
            f"{cfg.name}: prefix layers (first_dense) wait for ROADMAP A.4(d)")
    if cfg.layer_period() != 1:
        raise NotImplementedError(
            f"{cfg.name}: hybrid layer layouts wait for ROADMAP A.4(e)")
    if cfg.enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models wait for ROADMAP A.4(f)")


def param_specs(cfg: ModelConfig) -> dict:
    _refuse_unported(cfg)
    _, n = cfg.scan_layers()
    d = cfg.d_model
    s = {
        "embed": ParamSpec((cfg.padded_vocab, d), fan_in=d),
        "final_norm": ParamSpec((d,), "ones"),
        "decoder": {"blocks": {"sub0": _stack(_layer_specs(cfg, 0), n)}},
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((d, cfg.padded_vocab))
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
