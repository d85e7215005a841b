"""Autograd wrappers around the hand-written kernels, and their launch counts.

Dispatch is by the device of the input tensor, with no switch: a CUDA tensor
launches the kernel (or the wrapper raises), a CPU tensor takes the plain
version in ``kernels/ref.py`` (the experts' ragged products keep theirs in
``kernels/moe_gemm.py``, which also sends bf16 and fp16 to it).

Flash attention's and the SSD scan's backwards recompute through the plain
versions (``ref.flash_attention_ref``, ``ref.ssd_chunked_ref``), as
``repro.kernels.ops._flash_bwd`` and ``_ssd_bwd`` do: the JAX package has no
backward kernels either.  The experts' ragged product has no TPU kernel;
its backward is the same kernel in its two other forms.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.moe_gemm import NN, NT, TN, ragged_gemm
from repro_torch.kernels.pack import pack_leaves
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm_kernel
from repro_torch.kernels.ssd_scan import ssd_scan_fwd

_COUNTED = {"flash_attention": flash_attention_fwd, "moe_gemm": ragged_gemm,
            "pack": pack_leaves, "rmsnorm": _rmsnorm_kernel, "ssd": ssd_scan_fwd}


def launch_counts_by_dtype() -> Dict[str, Dict[str, int]]:
    """{kernel: {dtype name: launches}}: each wrapper's own count, kept by
    the dtype of the instantiation it launched."""
    return {name: dict(fn.launches) for name, fn in _COUNTED.items()}


def launch_counts() -> Dict[str, int]:
    """{kernel: launches} over every dtype."""
    return {name: sum(fn.launches.values()) for name, fn in _COUNTED.items()}


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches.clear()


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, _ = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = ref.flash_attention_ref(q, k, v, causal=ctx.causal,
                                          scale=ctx.scale)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """q: (B,S,H,hd); k,v: (B,S,KV,hd) -> (B,S,H,hd), differentiable."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return _FlashAttention.apply(q, k, v, causal, scale)


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, chunk: int):
        ctx.save_for_backward(x, dt, a_log, b, c)
        ctx.chunk = chunk
        return ssd_scan_fwd(x, dt, a_log, b, c, chunk=chunk)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = ref.ssd_chunked_ref(*inputs, chunk=ctx.chunk)
        grads = torch.autograd.grad(y, inputs, g)
        return (*grads, None)


def ssd(x, dt, a_log, b, c, *, chunk: int = 128):
    """x: (B,L,H,P); dt: (B,L,H) post-softplus; a_log: (H,); b,c: (B,L,G,N)
    -> (B,L,H,P), differentiable."""
    return _SSD.apply(x, dt, a_log, b, c, chunk)


class _RaggedMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, rows):
        ctx.save_for_backward(x, w, rows)
        return ragged_gemm(NN, x, w, rows)

    @staticmethod
    def backward(ctx, g):
        x, w, rows = ctx.saved_tensors
        dx = ragged_gemm(NT, g, w, rows) if ctx.needs_input_grad[0] else None
        dw = ragged_gemm(TN, x, g, rows) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def ragged_mm(x, w, rows):
    """x: (E,T,K) slots, each expert's ``rows[e]`` kept tokens first and
    zeros past them; w: (E,K,N) -> x @ w (E,T,N), differentiable, computed
    over the first ``rows[e]`` slots of each expert."""
    return _RaggedMM.apply(x, w, rows)


def rmsnorm(x, w, *, eps: float = 1e-5):
    """The RMSNorm kernel entry (forward only, like ``repro.kernels.ops``)."""
    return _rmsnorm_kernel(x, w, eps)


__all__ = ["flash_attention", "ragged_mm", "rmsnorm", "ssd", "launch_counts",
           "launch_counts_by_dtype", "reset_launch_counts"]
