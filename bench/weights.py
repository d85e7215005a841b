"""Weights from the seed, made on the device: one generator and one large
draw a leaf, keyed by the leaf's flat name, so any one leaf can be drawn
again alone (the readings after step 3 need the start of each leaf).

The benchmark hands the same values to both sides: it writes them into the
port's parameter tensors in place, and the reference draws them into its
own.  A matrix is normal(0, 1/sqrt(fan_in)); a norm's scale is one.
"""
from __future__ import annotations

import math
import zlib
from typing import Sequence

import torch

_MIX = 0x9E3779B97F4A7C15


def leaf_seed(seed: int, key: str) -> int:
    """A 63-bit generator seed from the run's seed (any size) and the leaf."""
    return (int(seed) * _MIX + zlib.crc32(key.encode())) % (1 << 63)


@torch.no_grad()
def fill_(t: torch.Tensor, seed: int, key: str, init: str, fan_in: int) -> torch.Tensor:
    """Draw leaf ``key`` into the contiguous tensor ``t`` in place."""
    if not t.is_contiguous():
        raise ValueError(f"{key}: weights are drawn into contiguous tensors only")
    if init == "ones":
        return t.fill_(1.0)
    if init != "normal":
        raise ValueError(f"{key}: unknown init {init!r}")
    gen = torch.Generator(device=t.device)
    gen.manual_seed(leaf_seed(seed, key))
    return t.normal_(generator=gen).mul_(1.0 / math.sqrt(fan_in))


def make(shape: Sequence[int], seed: int, key: str, init: str, fan_in: int,
         device, dtype=torch.float32) -> torch.Tensor:
    return fill_(torch.empty(tuple(shape), dtype=dtype, device=device),
                 seed, key, init, fan_in)
