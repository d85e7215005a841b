"""Deterministic synthetic token stream (numpy copy of
``repro.data.pipeline``; produces the same batches bit for bit).

The global batch at step ``t`` is a pure function of ``(seed, t)``,
independent of the replica count, so a rescaled run re-splits the same
global batch and reproduces the static run's trajectory.  An
encoder-decoder model's stream adds the encoder's input frames
(``EncDecStream``: float32 ``enc_embeds``, the audio frontend stub's output).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class TokenStream:
    seed: int
    vocab_size: int
    global_batch: int
    seq_len: int

    def _rng(self, step: int, salt: int = 0) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, salt]))

    def global_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Batch dict with (global_batch, seq_len) int32 tokens/labels."""
        rng = self._rng(step)
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        ranks = np.arange(1, V + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        base = rng.choice(V, size=(B, S + 1), p=probs).astype(np.int64)
        # learnable structure: every even position is a deterministic
        # function of the previous token
        nxt = (base * 2654435761 % V).astype(np.int64)
        base[:, 1::2] = nxt[:, 0:-1:2]
        return {"tokens": np.ascontiguousarray(base[:, :-1]).astype(np.int32),
                "labels": np.ascontiguousarray(base[:, 1:]).astype(np.int32)}

    def shard_bounds(self, replica_idx: int, num_replicas: int) -> Tuple[int, int]:
        if self.global_batch % num_replicas:
            raise ValueError(f"global_batch {self.global_batch} not divisible "
                             f"by {num_replicas}")
        per = self.global_batch // num_replicas
        return replica_idx * per, (replica_idx + 1) * per

    def shard_at(self, step: int, replica_idx: int, num_replicas: int):
        batch = self.global_batch_at(step)
        lo, hi = self.shard_bounds(replica_idx, num_replicas)
        return {k: v[lo:hi] for k, v in batch.items()}


@dataclass(frozen=True)
class EncDecStream(TokenStream):
    """Adds deterministic encoder frame embeddings (frontend stub output):
    (global_batch, enc_len, d_model) float32 ``enc_embeds``."""
    enc_len: int = 0
    d_model: int = 0

    def global_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        batch = super().global_batch_at(step)
        rng = self._rng(step, salt=1)
        batch["enc_embeds"] = rng.standard_normal(
            (self.global_batch, self.enc_len, self.d_model)).astype(np.float32)
        return batch


def make_stream(cfg, *, seed: int, global_batch: int, seq_len: int,
                enc_len: int = 0) -> TokenStream:
    """An ``EncDecStream`` (``enc_len`` frames, ``seq_len`` by default) for
    a model with an encoder, else a ``TokenStream``."""
    if cfg.enc_layers:
        return EncDecStream(seed=seed, vocab_size=cfg.vocab_size,
                            global_batch=global_batch, seq_len=seq_len,
                            enc_len=enc_len or seq_len, d_model=cfg.d_model)
    return TokenStream(seed=seed, vocab_size=cfg.vocab_size,
                       global_batch=global_batch, seq_len=seq_len)
