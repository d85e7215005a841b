"""Ragged batched products of the MoE experts: wrapper of ``csrc/moe_gemm.cu``
and its plain version.

The gather dispatch (``models/moe.py``) lays each expert's kept tokens first
in its block of T = B*C slots and counts them in ``rows``, an int32 (E,)
tensor on the device.  ``ragged_gemm`` computes one of three batched forms
over the first ``rows[e]`` slots of each expert e, so no host sync learns the
counts:

- ``NN``: a = X (E,T,K), b = W (E,K,N) -> X @ W, (E,T,N);
- ``NT``: a = G (E,T,N), b = W (E,K,N) -> G @ W^T, (E,T,K);
- ``TN``: a = X (E,T,K), b = G (E,T,N) -> X^T @ G, (E,K,N), a sum over the
  first ``rows[e]`` slots.

Rows past ``rows[e]`` of an NN or NT output are zero.  The layout keeps the
slots past ``rows[e]`` zero, so each form equals ``torch.bmm`` over the whole
layout, which is the plain version (``ragged_gemm_ref``).

Dispatch is by the tensors' dtype and device, with no switch: float32 on a
card launches the kernel (or raises); float32 on meta (the dry-run's trace)
gets an empty output and notes the padded product's operations to
``utils.memtrace``, with no launch; every other case takes the plain version:
a CPU tensor, and bf16 or fp16 on a card, where ``torch.bmm`` runs on the
tensor cores and the kernel's FFMA tiles would be slower.
``ragged_gemm.launches`` counts kernel launches, by dtype.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.utils import memtrace

NN, NT, TN = 0, 1, 2
ROW_TILE = 128          # the kernel's row tile: the rows it computes an expert


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("moe_gemm").moe_gemm
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def runs_kernel(t: torch.Tensor) -> bool:
    """Whether ``ragged_gemm`` takes the kernel for operands like ``t``:
    float32 on a card, or on meta, the card's dry-run."""
    return t.dtype == torch.float32 and t.device.type in ("cuda", "meta")


def rows_computed(rows: torch.Tensor, T: int, like: torch.Tensor):
    """The slot rows an NN or NT product over operands like ``like``
    computes, summed over the experts: where the kernel runs, each
    ``rows[e]`` rounded up to the kernel's row tile, at most T (a device
    scalar); where the plain version runs, all E*T slots (an int)."""
    if not runs_kernel(like):
        return rows.numel() * T
    tiles = (rows.long() + ROW_TILE - 1) // ROW_TILE
    return torch.clamp(tiles * ROW_TILE, max=T).sum()


def _shapes(form: int, a: torch.Tensor, b: torch.Tensor):
    """(E, T, K, N) of a ``form`` product, checked against both operands."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0]:
        raise ValueError(f"ragged_gemm takes two (E, ., .) operands, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    E, T = a.shape[:2]
    if form == NN and a.shape[2] == b.shape[1]:
        return E, T, a.shape[2], b.shape[2]
    if form == NT and a.shape[2] == b.shape[2]:
        return E, T, b.shape[1], a.shape[2]
    if form == TN and a.shape[1] == b.shape[1]:
        return E, T, a.shape[2], b.shape[2]
    raise ValueError(f"form {form}: operands {tuple(a.shape)} and "
                     f"{tuple(b.shape)} do not match")


def ragged_gemm_ref(form: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: the ``form`` product over every slot."""
    if form == NN:
        return torch.bmm(a, b)
    if form == NT:
        return torch.bmm(a, b.transpose(1, 2))
    return torch.bmm(a.transpose(1, 2), b)


def ragged_gemm(form: int, a: torch.Tensor, b: torch.Tensor,
                rows: torch.Tensor) -> torch.Tensor:
    """The ``form`` product (``NN``, ``NT`` or ``TN``) over the first
    ``rows[e]`` slots of each expert e."""
    E, T, K, N = _shapes(form, a, b)
    if a.device != b.device or a.dtype != b.dtype:
        raise ValueError(f"operands on {a.device}/{b.device} as {a.dtype}/{b.dtype}: "
                         "ragged_gemm takes one device and dtype")
    if tuple(rows.shape) != (E,) or rows.dtype != torch.int32:
        raise ValueError(f"rows {tuple(rows.shape)} {rows.dtype}: want ({E},) int32")
    if a.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"ragged_gemm runs on cuda, cpu or meta, not {a.device}")
    if not runs_kernel(a):
        return ragged_gemm_ref(form, a, b)
    out_shape = {NN: (E, T, N), NT: (E, T, K), TN: (E, K, N)}[form]
    out = torch.empty(out_shape, dtype=a.dtype, device=a.device)
    if a.device.type == "meta":
        memtrace.note_kernel_flops("moe_gemm", 2 * E * T * K * N)
        return out
    if rows.device != a.device:
        raise ValueError(f"rows on {rows.device}, operands on {a.device}")
    a, b, rows = a.contiguous(), b.contiguous(), rows.contiguous()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _fn()(form, a.data_ptr(), b.data_ptr(), out.data_ptr(), rows.data_ptr(),
                    E, T, K, N, stream)
    if err:
        raise RuntimeError(f"moe_gemm launch failed: cudaError {err}")
    ragged_gemm.launches["float32"] += 1
    return out


ragged_gemm.launches = Counter()
