"""In-memory checkpoint store, the /dev/shm analog (copy of
``repro.checkpoint.memory`` over the port's snapshot)."""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from repro_torch.checkpoint.reshard import snapshot_to_host


class MemoryCheckpointStore:
    def __init__(self):
        self._store: Dict[str, Dict[str, np.ndarray]] = {}
        self._meta: Dict[str, dict] = {}

    def save(self, job_id: str, tree, meta: Optional[dict] = None, *,
             fused: bool = False) -> float:
        """Checkpoint ``tree`` under ``job_id``; returns seconds taken.

        ``fused=True`` routes the device->host copies through the pack
        kernel (one transfer per dtype group)."""
        t0 = time.perf_counter()
        self._store[job_id] = snapshot_to_host(tree, fused=fused)
        self._meta[job_id] = dict(meta or {}, saved_at=time.time())
        return time.perf_counter() - t0

    def load(self, job_id: str) -> Dict[str, np.ndarray]:
        return self._store[job_id]

    def meta(self, job_id: str) -> dict:
        return self._meta[job_id]

    def nbytes(self, job_id: str) -> int:
        return sum(a.nbytes for a in self._store[job_id].values())

    def delete(self, job_id: str):
        self._store.pop(job_id, None)
        self._meta.pop(job_id, None)

    def __contains__(self, job_id: str) -> bool:
        return job_id in self._store
