"""Fused gather/pack of same-dtype leaves: wrapper of ``csrc/pack.cu``, and
the fused device->host snapshot built on it.

Counterpart of ``repro.kernels.pack`` (``pack_leaves_pallas`` and
``packed_snapshot_to_host``).  A CUDA tensor launches the hand-written kernel
or raises; CPU tensors take ``ref.pack_leaves_ref``.  ``pack_leaves.launches``
counts kernel launches and nothing else, by the leaves' dtype (bfloat16
takes the 2-byte instantiation).
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.reshard import host_array
from repro_torch.kernels import _build, ref

LANE = ref.PACK_LANE
BLOCK_ROWS = ref.PACK_BLOCK_ROWS
BLOCK = LANE * BLOCK_ROWS


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("pack").pack_leaves
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def padded_numel(n: int) -> int:
    return n + (-n) % BLOCK


def pack_leaves(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Pack same-dtype ``leaves`` into one ``(total_blocks*8, 128)`` buffer,
    leaf-major, each leaf zero-padded to a 1024-element block."""
    leaves = list(leaves)
    if not leaves:
        raise ValueError("pack_leaves needs at least one leaf")
    dev, dt = leaves[0].device, leaves[0].dtype
    if any(t.device != dev or t.dtype != dt for t in leaves):
        raise ValueError("pack_leaves takes leaves of one device and dtype")
    if any(t.numel() == 0 for t in leaves):
        raise ValueError("pack_leaves takes no zero-size leaf")
    if dev.type == "cpu":
        return ref.pack_leaves_ref(leaves)
    if dev.type != "cuda":
        raise ValueError(f"pack_leaves runs on cuda or cpu, not {dev}")
    leaves = [t if t.is_contiguous() else t.contiguous() for t in leaves]
    tiles = [padded_numel(t.numel()) // BLOCK for t in leaves]
    starts = np.cumsum([0] + tiles[:-1]).tolist()
    total = sum(tiles)
    table = torch.tensor([t.data_ptr() for t in leaves] + starts
                         + [t.numel() for t in leaves], dtype=torch.int64)
    table = table.to(dev)
    out = torch.empty((total * BLOCK_ROWS, LANE), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(table.data_ptr(), len(leaves), total, out.data_ptr(),
                    out.element_size(), stream)
    if err:
        raise RuntimeError(f"pack_leaves launch failed: cudaError {err}")
    pack_leaves.launches[str(dt).removeprefix("torch.")] += 1
    return out


pack_leaves.launches = Counter()


def packed_snapshot_to_host(flat: Dict[str, torch.Tensor]
                            ) -> Dict[str, np.ndarray]:
    """Fused device->host snapshot of a flat ``{key: tensor}`` dict: one
    packed buffer and one copy into (pinned, for CUDA) host memory per dtype
    group.  The returned arrays are views into that fresh host buffer, which
    no live tensor shares; a bfloat16 group goes through the kernel's 2-byte
    instantiation and comes back as ``V2`` views (``reshard.host_array``).
    Zero-size leaves are not sent."""
    groups: Dict[torch.dtype, List[str]] = {}
    out: Dict[str, np.ndarray] = {}
    for k, t in flat.items():
        if t.numel() == 0:
            out[k] = host_array(torch.empty(t.shape, dtype=t.dtype))
        else:
            groups.setdefault(t.dtype, []).append(k)
    for dt, ks in groups.items():
        leaves = [flat[k].detach() for k in ks]
        packed = pack_leaves(leaves)
        host = torch.empty(packed.numel(), dtype=dt, pin_memory=packed.is_cuda)
        host.copy_(packed.reshape(-1))
        host = host_array(host)
        off = 0
        for k, t in zip(ks, leaves):
            out[k] = host[off:off + t.numel()].reshape(tuple(t.shape))
            off += padded_numel(t.numel())
    return {k: out[k] for k in flat}          # original key order
