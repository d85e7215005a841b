"""Parameter specs and initialisation (counterpart of
``repro.models.params`` for the dense GQA + SwiGLU decoder).

Shapes and the ``/``-joined flat keys equal
``repro.checkpoint.reshard.flatten_tree(repro.models.params.init_params(cfg,
key))``; the distributions equal the reference's (``normal`` scaled by
``1/sqrt(fan_in)``, norms at one).  The bits differ, since a
``torch.Generator`` is not ``jax.random``: parity tests carry the reference's
parameters across with ``from_numpy_flat``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint.reshard import (nest_flat, snapshot_to_host,
                                            tree_path_keys, unflatten_tree)
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"              # normal | ones
    fan_in: int = 0                   # 0 => shape[0]


def _layer_specs(cfg: ModelConfig, n: int) -> dict:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)

    def stacked(shape, init="normal", fan_in=0):
        return ParamSpec((n,) + shape, init, fan_in or shape[0])

    return {
        "mixer_norm": stacked((d,), "ones"),
        "mixer": {
            "wq": stacked((d, h, hd)),
            "wk": stacked((d, kv, hd)),
            "wv": stacked((d, kv, hd)),
            "wo": stacked((h, hd, d), fan_in=h * hd),
        },
        "ff_norm": stacked((d,), "ones"),
        "ff": {
            "w_gate": stacked((d, cfg.d_ff)),
            "w_up": stacked((d, cfg.d_ff)),
            "w_down": stacked((cfg.d_ff, d), fan_in=cfg.d_ff),
        },
    }


def param_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    _, n = cfg.scan_layers()
    return {
        "embed": ParamSpec((cfg.padded_vocab, d), fan_in=d),
        "final_norm": ParamSpec((d,), "ones"),
        "decoder": {"blocks": {"sub0": _layer_specs(cfg, n)}},
        "lm_head": ParamSpec((d, cfg.padded_vocab)),
    }


def _init_leaf(spec: ParamSpec, gen: torch.Generator, dtype, device):
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init != "normal":
        raise ValueError(spec.init)
    t = torch.empty(spec.shape, dtype=torch.float32, device=device)
    t.normal_(generator=gen)
    t.mul_(1.0 / math.sqrt(spec.fan_in or spec.shape[0]))
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
