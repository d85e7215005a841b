"""Autograd wrappers around the hand-written kernels, and their launch counts.

Dispatch is by the device of the input tensor, with no switch: a CUDA tensor
launches the kernel (or the wrapper raises), a CPU tensor takes the plain
version in ``kernels/ref.py``.

Flash attention's and the SSD scan's backwards recompute through the plain
versions (``ref.flash_attention_ref``, ``ref.ssd_chunked_ref``), as
``repro.kernels.ops._flash_bwd`` and ``_ssd_bwd`` do: the JAX package has no
backward kernels either.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.pack import pack_leaves
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm_kernel
from repro_torch.kernels.ssd_scan import ssd_scan_fwd

_COUNTED = {"flash_attention": flash_attention_fwd, "pack": pack_leaves,
            "rmsnorm": _rmsnorm_kernel, "ssd": ssd_scan_fwd}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0


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


def rmsnorm(x, w, *, eps: float = 1e-5):
    """The RMSNorm kernel entry (forward only, like ``repro.kernels.ops``)."""
    return _rmsnorm_kernel(x, w, eps)


__all__ = ["flash_attention", "rmsnorm", "ssd", "launch_counts",
           "reset_launch_counts"]
