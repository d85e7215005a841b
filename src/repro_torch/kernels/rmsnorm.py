"""Fused row RMSNorm in Triton.

Replaces the TPU kernel ``_rmsnorm_kernel`` / ``rmsnorm_pallas`` in
``src/repro/kernels/rmsnorm.py``: float32 mean of squares, ``rsqrt(var+eps)
* w``, cast back to the input's type.

What bounds it on the H100: bytes.  It reads x and w once and writes y once;
at (16384, 4096) float32 that is 537 MB, about 0.16 ms at 3.35 TB/s.  What
the design does about it: one program per block of rows holds whole rows in
registers, so the sum of squares and the scaled write are one pass over x
(Triton serves a single row reduction fused with an elementwise pass as well
as CUDA would).

A CUDA tensor launches the kernel or raises; a CPU tensor takes
``ref.rmsnorm_ref``; a meta tensor (the dry-run's trace) gets an empty
output of the kernel's shape, with no launch and no Triton.  ``triton`` is
imported inside the launching function, because it exists only where there
is a card.  ``rmsnorm.launches`` counts kernel launches and nothing else, by
x's dtype.  (No ``from __future__ import annotations`` here: Triton reads
the ``tl.constexpr`` annotations as objects.)
"""
import functools
from collections import Counter

import torch

from repro_torch.kernels import ref

MAX_BLOCK_ELEMS = 16384     # elements of x one program holds in registers
tl = None                   # triton.language, bound at the first launch


@functools.lru_cache(maxsize=None)
def _kernel():
    # the kernel body looks ``tl`` up in this module's globals
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_kernel(x_ptr, w_ptr, o_ptr, n_rows, D, stride_x, stride_o,
                       eps, BLOCK_ROWS: tl.constexpr, BLOCK_D: tl.constexpr):
        rows = (tl.program_id(0) * BLOCK_ROWS
                + tl.arange(0, BLOCK_ROWS)).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < D
        mask = (rows < n_rows)[:, None] & cmask[None, :]
        x = tl.load(x_ptr + rows[:, None] * stride_x + cols[None, :],
                    mask=mask, other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=1) / D
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        y = x * tl.rsqrt(var + eps)[:, None] * w[None, :]
        tl.store(o_ptr + rows[:, None] * stride_o + cols[None, :],
                 y.to(o_ptr.dtype.element_ty), mask=mask)

    return triton, rmsnorm_kernel


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); w: (D,)."""
    D = x.shape[-1]
    if w.shape != (D,) or w.device != x.device:
        raise ValueError(f"weight {tuple(w.shape)} on {w.device} does not fit "
                         f"x {tuple(x.shape)} on {x.device}")
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, w, eps)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"rmsnorm runs on cuda, cpu or meta, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"rmsnorm takes a floating x, got {x.dtype}")
    block_d = 1 << max(D - 1, 0).bit_length()          # next power of two
    if block_d > MAX_BLOCK_ELEMS:
        raise ValueError(f"rows of {D} elements exceed one program's block")
    x2 = x.reshape(-1, D)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    out = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    if x.device.type == "meta":
        return out.reshape(x.shape)
    triton, kernel = _kernel()
    block_rows = max(1, min(16, MAX_BLOCK_ELEMS // block_d))
    n = x2.shape[0]
    grid = (triton.cdiv(n, block_rows),)
    with torch.cuda.device(x.device):
        kernel[grid](x2, w, out, n, D, x2.stride(0), out.stride(0), eps,
                     BLOCK_ROWS=block_rows, BLOCK_D=block_d,
                     num_warps=8 if block_d >= 2048 else 4)
    rmsnorm.launches[str(x.dtype).removeprefix("torch.")] += 1
    return out.reshape(x.shape)


rmsnorm.launches = Counter()
