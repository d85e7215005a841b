"""Mamba-2 SSD chunked scan forward: wrapper of ``csrc/ssd_scan.cu``.

Counterpart of ``repro.kernels.ssd_scan.ssd_chunked_pallas`` (the TPU
kernel).  A CUDA tensor launches the hand-written kernel or raises; a CPU
tensor takes the plain version ``ref.ssd_chunked_ref``.  The kernel runs as
three launches on the current stream (chunk states, state passing, chunk
scan; ``ref.ssd_split_ref`` is their plain version), with scratch allocated
here.  A meta tensor (the dry-run's trace) gets an empty y, and the
wrapper allocates on meta the scratch its CUDA branch allocates and notes
the scan's operations to ``utils.memtrace``, with no launch.
``ssd_scan_fwd.launches`` counts wrapper calls that launched the kernel, and
nothing else, by x's dtype.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from repro_torch.kernels import _build, ref
from repro_torch.utils import memtrace

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128    # limits of the kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("ssd_scan").ssd_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def chunk_len(L: int, chunk: int) -> int:
    """The chunk length a sequence of ``L`` tokens is scanned in,
    min(chunk, L); raises unless it divides L."""
    Q = min(chunk, L)
    if Q <= 0 or L % Q:
        raise ValueError(f"sequence length {L} is not a multiple of chunk {Q}")
    return Q


def _check(x, dt, a_log, b, c, chunk: int) -> int:
    """Validates the inputs; returns the chunk length actually used."""
    if len({t.device for t in (x, dt, a_log, b, c)}) != 1:
        raise ValueError("x, dt, a_log, b, c must lie on one device")
    if x.dtype not in _DTYPES or not (x.dtype == b.dtype == c.dtype):
        raise TypeError(f"ssd takes float32 or bfloat16 x/b/c of one dtype, "
                        f"got {x.dtype}, {b.dtype}, {c.dtype}")
    if not (dt.is_floating_point() and a_log.is_floating_point()):
        raise TypeError("dt and a_log must be floating point")
    if x.dim() != 4 or b.dim() != 4 or b.shape != c.shape:
        raise ValueError(f"shapes {tuple(x.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}: want (B,L,H,P), (B,L,G,N) x2")
    B, L, H, P = x.shape
    if tuple(dt.shape) != (B, L, H) or tuple(a_log.shape) != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / a_log {tuple(a_log.shape)} "
                         f"do not match x {tuple(x.shape)}")
    if b.shape[:2] != x.shape[:2] or H % b.shape[2]:
        raise ValueError(f"b/c {tuple(b.shape)}: batch and length of x, and a "
                         f"group count dividing {H} heads")
    return chunk_len(L, chunk)


def ssd_scan_fwd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128
                 ) -> torch.Tensor:
    """x: (B,L,H,P); dt: (B,L,H) post-softplus; a_log: (H,); b,c: (B,L,G,N)
    -> y (B,L,H,P) in x's type, with a float32 state (no gradient: see
    ``ops.ssd``)."""
    Q = _check(x, dt, a_log, b, c, chunk)
    if x.device.type == "cpu":
        return ref.ssd_chunked_ref(x, dt, a_log, b, c, chunk=Q)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd runs on cuda, cpu or meta, not {x.device}")
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if Q > MAX_CHUNK or P > MAX_HEAD_DIM or N > MAX_STATE:
        raise ValueError(f"the kernel takes chunk <= {MAX_CHUNK}, head_dim <= "
                         f"{MAX_HEAD_DIM}, d_state <= {MAX_STATE}; got {Q}, "
                         f"{P}, {N}")
    x, b, c = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, b, c))
    dt = dt.to(torch.float32).contiguous()
    a_log = a_log.to(torch.float32).contiguous()
    y = torch.empty((B, L, H, P), dtype=x.dtype, device=x.device)
    nc = L // Q         # scratch of the three phases: cumsums, chunk states
    cum = torch.empty((B, nc, H, Q), dtype=torch.float32, device=x.device)
    states = torch.empty((B, nc, H, N, P), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        # causal pairs only; the C.B^T scores once a group, then a head's
        # masked scores times x and its state terms
        pairs = Q * (Q + 1) // 2
        memtrace.note_kernel_flops(
            "ssd", B * nc * (G * 2 * pairs * N + H * (2 * pairs * P + 4 * Q * N * P)))
        return y
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (x, b, c)
                                        for i in range(3)))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _fn()(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
                    c.data_ptr(), y.data_ptr(), cum.data_ptr(),
                    states.data_ptr(), B, L, H, G, P, N, Q, strides,
                    _DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError(f"ssd_scan_fwd launch failed: cudaError {err}")
    ssd_scan_fwd.launches[str(x.dtype).removeprefix("torch.")] += 1
    return y


ssd_scan_fwd.launches = Counter()
