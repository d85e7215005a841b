"""Token batches from the seed, for one training mix.

The global batch of step ``t`` is a pure function of ``(seed, t)``: ids drawn
from a Zipf law over the vocabulary (``zipf_s`` of the mix), labels the next
ids, every label trained.  Every seed gives the same sizes, so the work of a
step never depends on the seed.  ``Stream`` has the two methods the port's
trainer reads from its ``stream``: ``global_batch_at`` and ``shard_bounds``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


class Stream:
    def __init__(self, seed: int, vocab_size: int, global_batch: int, seq_len: int,
                 zipf_s: float):
        self.seed, self.vocab_size = int(seed), vocab_size
        self.global_batch, self.seq_len = global_batch, seq_len
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        cdf = np.cumsum(ranks ** -float(zipf_s))
        self._cdf = cdf / cdf[-1]

    def global_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(
            np.random.SeedSequence([self.seed, int(step)])))
        u = rng.random((self.global_batch, self.seq_len + 1))
        ids = np.minimum(np.searchsorted(self._cdf, u, side="right"),
                         self.vocab_size - 1).astype(np.int32)
        return {"tokens": np.ascontiguousarray(ids[:, :-1]),
                "labels": np.ascontiguousarray(ids[:, 1:])}

    def shard_bounds(self, replica_idx: int, num_replicas: int) -> Tuple[int, int]:
        if self.global_batch % num_replicas:
            raise ValueError(f"global_batch {self.global_batch} not divisible "
                             f"by {num_replicas}")
        per = self.global_batch // num_replicas
        return replica_idx * per, (replica_idx + 1) * per


def trained_tokens(batch: Dict[str, np.ndarray]) -> int:
    return int((batch["labels"] >= 0).sum())
