"""Causal GQA flash-attention forward: wrapper of ``csrc/flash_attention.cu``.

Counterpart of ``repro.kernels.flash_attention.flash_attention_fwd`` (the TPU
kernel).  A CUDA tensor launches the hand-written kernel or raises; a CPU
tensor takes the plain version in ``kernels/ref.py``.  ``launches`` counts
kernel launches and nothing else, by the dtype of the instantiation launched
(``{"float32": n, "bfloat16": n}``).
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash attention takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}: want (B,S,H,hd), (B,S,KV,hd)")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError("k/v must share q's batch, sequence and head_dim")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads not divisible by {k.shape[2]} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")


def _rows_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if the kernel's 16-byte copies can read it in place (last
    dimension contiguous, other strides and the start 16-byte aligned), else a
    contiguous copy."""
    per16 = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % per16 == 0 for s in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B,S,H,hd); k,v: (B,S,KV,hd) -> (out (B,S,H,hd), lse (B,H,S) fp32)."""
    _check(q, k, v)
    B, S, H, hd = q.shape
    scale = hd ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return (ref.flash_attention_ref(q, k, v, causal=causal, scale=scale),
                ref.attention_lse_ref(q, k, causal=causal, scale=scale))
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    q, k, v = (_rows_aligned(t) for t in (q, k, v))
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v)
                                        for i in range(3)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), B, S, H, k.shape[2], hd, strides, scale,
                    int(causal), _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    flash_attention_fwd.launches[str(q.dtype).removeprefix("torch.")] += 1
    return out, lse


flash_attention_fwd.launches = Counter()
