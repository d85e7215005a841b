"""Live-bytes tracker of a traced step: the port's counterpart of
``compiled.memory_analysis()``.

``MemTracker`` is a ``TorchDispatchMode``.  Every op that runs under it
hands it its outputs; a storage it has not seen is new, and its bytes are
added to the live count until the storage is freed (a ``weakref.finalize``
on the storage subtracts them).  Views and in-place ops return storages it
has already seen, so they add nothing.  Sizes are rounded up to the CUDA
caching allocator's 512-byte block, as ``torch.cuda.max_memory_allocated``
counts them.  It counts only storages on one device type, so the CPU
tensors of a wrapper's bookkeeping do not enter a card's or a meta trace's
count.

Some CUDA kernels allocate temporaries of their own, which no op returns
and a meta kernel never makes.  Two of them are large beside a step's peak,
and the tracker counts them from their inputs' shapes and strides while the
op runs (``INTERNAL``): ``_softmax_backward_data`` forms ``grad * output``
and then contiguous copies of that product and of ``output`` (the plain
attention backward's S x S scores, 6.44 GB at granite-moe-3b-a800m's batch
8 x 2048 on an NVIDIA H100 80GB HBM3, 700 W); ``logsumexp`` forms ``self -
max`` (one chunk of the loss's logits).  The cuBLAS workspace (64 MiB, made
at a thread's first product) and the staging buffers of large reductions
are not counted.

It runs the same on meta tensors (the dry-run, which allocates nothing) and
on real ones, so the card can hold a meta trace's peak against the
allocator's for the same step.  The autograd engine carries the mode into
the backward, so a step's backward and its checkpoint recomputes are
counted too.

The tensors live when the tracker is entered (a step's arguments) are
given to it as ``entry``; ``entry_bytes`` is their storages' bytes, and
``peak_bytes`` the most that was live at once, entry included.
``bytes_accessed`` sums every op's operand and result bytes on the device
(each op on its own, as XLA's unfused ``bytes accessed`` counts them).

The kernel wrappers' meta branches launch nothing, so no op tells a
``FlopCounterMode`` what they compute; they note their operations with
``note_kernel_flops``, which adds them to every active tracker's
``kernel_flops``.
"""
from __future__ import annotations

import weakref
from collections import Counter
from typing import Iterable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

BLOCK = 512                 # bytes: the CUDA caching allocator's rounding

_ACTIVE: List["MemTracker"] = []


def note_kernel_flops(name: str, flops: int) -> None:
    """Add ``flops`` under ``name`` to every active tracker's
    ``kernel_flops`` (a kernel wrapper's meta branch calls it)."""
    for t in _ACTIVE:
        t.kernel_flops[name] += flops


def _rounded(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def _bytes(t: torch.Tensor) -> int:
    return _rounded(t.numel() * t.element_size())


def _like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="meta")


def _softmax_backward_temps(grad, output, *rest) -> int:
    """CUDA's softmax backward: ``tmp = grad * output``, then
    ``tmp.contiguous()`` and ``output.contiguous()``."""
    tmp = _like(grad) * _like(output)           # its layout, on meta
    return (_bytes(tmp) * (1 if tmp.is_contiguous() else 2)
            + (0 if output.is_contiguous() else _bytes(output)))


def _logsumexp_temps(x, dim, keepdim=False) -> int:
    """``maxes = amax(x, dim, keepdim=True)``, its infinity mask, and
    ``x - maxes``."""
    maxes = torch.amax(_like(x), dim, keepdim=True)
    return _bytes(x) + _bytes(maxes) + _rounded(maxes.numel())


INTERNAL = {aten._softmax_backward_data.default: _softmax_backward_temps,
            aten.logsumexp.default: _logsumexp_temps}


class MemTracker(TorchDispatchMode):
    """Live and peak bytes of the storages on ``device`` (a device type:
    ``"meta"`` or ``"cuda"``) while the mode is active."""

    def __init__(self, device: str, entry: Iterable[torch.Tensor] = ()):
        super().__init__()
        self.device = torch.device(device).type
        self._live = {}             # storage id -> rounded bytes
        self.kernel_flops = Counter()
        self.bytes_accessed = 0
        self.live_bytes = self.peak_bytes = 0
        for t in entry:
            self._track(t)
        self.entry_bytes = self.live_bytes

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def _free(self, key):
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor):
        if t.device.type != self.device:
            return
        st = t.untyped_storage()
        key = st._cdata
        n = _rounded(st.nbytes())
        old = self._live.get(key)
        if old is None:
            weakref.finalize(st, self._free, key)
        elif old >= n:
            return
        self._live[key] = n
        self.live_bytes += n - (old or 0)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        before = self.live_bytes
        out = func(*args, **kwargs)
        for t in tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor) and t.device.type == self.device:
                self.bytes_accessed += t.numel() * t.element_size()
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
                if t.device.type == self.device:
                    self.bytes_accessed += t.numel() * t.element_size()
        temps = INTERNAL.get(func)
        if temps is not None and args[0].device.type == self.device:
            self.peak_bytes = max(self.peak_bytes, max(before, self.live_bytes)
                                  + temps(*args, **kwargs))
        return out


__all__ = ["MemTracker", "note_kernel_flops", "BLOCK"]
