"""Parameter specs and initialisation (counterpart of
``repro.models.params`` for the dense GQA + SwiGLU and the Mamba-2 decoders).

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

from repro_torch.checkpoint.reshard import (nest_flat, snapshot_to_host,
                                            tree_path_keys, unflatten_tree)
from repro_torch.configs.base import ATTN, FF_NONE, FF_SWIGLU, SSM, ModelConfig
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
    return {
        "wq": ParamSpec((d, h, hd)),
        "wk": ParamSpec((d, kv, hd)),
        "wv": ParamSpec((d, kv, hd)),
        "wo": ParamSpec((h, hd, d), fan_in=h * hd),
    }


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


def _ffn_specs(cfg: ModelConfig, kind: str) -> dict:
    if kind != FF_SWIGLU:
        raise ValueError(f"ffn kind {kind!r} is not ported yet")
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((d, f)),
        "w_up": ParamSpec((d, f)),
        "w_down": ParamSpec((f, d), fan_in=f),
    }


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
        s["ff"] = _ffn_specs(cfg, ff)
    return s


def _stack(tree, n: int):
    """Prefix every leaf spec with a stacked 'layers' axis of length n."""
    if isinstance(tree, dict):
        return {k: _stack(v, n) for k, v in tree.items()}
    return ParamSpec((n,) + tree.shape, tree.init, tree.fan_in or tree.shape[0])


def param_specs(cfg: ModelConfig) -> dict:
    _, n = cfg.scan_layers()
    if cfg.layer_period() != 1:
        raise NotImplementedError(
            f"{cfg.name}: hybrid layer layouts wait for their family's slice")
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

    Floating leaves get ``requires_grad`` unless told otherwise."""
    dev = resolve_device(device)

    def put(a):
        arr = np.asarray(a)
        if arr.dtype.kind == "V":
            raise NotImplementedError(
                f"numpy dtype {arr.dtype} (bfloat16 via ml_dtypes) cannot be "
                "read without ml_dtypes")
        t = torch.from_numpy(np.array(arr, copy=True)).to(dev)
        rg = t.is_floating_point() if requires_grad is None else requires_grad
        return t.requires_grad_(rg and t.is_floating_point())
    return nest_flat({k: put(v) for k, v in flat.items()})


def to_numpy_flat(tree) -> dict:
    """The port's tree -> ``{flatten_tree key: ndarray}`` (copies)."""
    return snapshot_to_host(tree)
