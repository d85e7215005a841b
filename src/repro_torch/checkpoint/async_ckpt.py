"""Async checkpoint writes — overlap the disk write with compute.

Counterpart of ``repro.checkpoint.async_ckpt``.  The paper's preempt path is
synchronous: stop stepping, snapshot, write, release the slots.  That puts
the full disk write on the critical path of every preemption.
``AsyncCheckpointer`` moves it off: ``submit`` snapshots the tree to host RAM
*inline*, then hands the disk write to a single background worker thread.
Training continues while the npz lands.

The port's AdamW updates parameters and moments IN PLACE (the reference may
keep views because JAX arrays are immutable).  So ``submit`` returns only
once the host copy is complete: ``snapshot_to_host`` copies every leaf (or
every packed dtype group, with ``fused=True``) into fresh host memory with a
synchronous device-to-host copy, and the next in-place ``step()`` cannot
reach the snapshot.  The worker thread sees numpy arrays only, never a
tensor on the card.

At preempt time the scheduler calls ``barrier()``: it joins all pending
writes, so the store's ``latest_step`` is guaranteed to name a fully
published (``os.replace``d) checkpoint — never a half-written one.  A write
that raised re-raises at the barrier instead of being silently dropped.

Serialization: one worker thread per checkpointer, writes drain in submit
order, so delta checkpoints chain correctly (each save sees its
predecessor's manifest).
"""
from __future__ import annotations

import queue
import threading
from typing import Optional

from repro_torch.checkpoint.disk import DiskCheckpointStore
from repro_torch.checkpoint.reshard import snapshot_to_host


class AsyncCheckpointer:
    def __init__(self, store: DiskCheckpointStore, *, delta: bool = True):
        self.store = store
        self.delta = delta
        self._q: "queue.Queue" = queue.Queue()
        self._errors: list = []
        self._lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        self.pending = 0
        self.completed = 0

    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            job_id, step, flat, meta = item
            try:
                self.store.save_flat(job_id, step, flat, meta,
                                     delta=self.delta)
                with self._lock:
                    self.completed += 1
            except BaseException as e:      # surfaced at barrier()
                with self._lock:
                    self._errors.append(e)
            finally:
                with self._lock:
                    self.pending -= 1
                self._q.task_done()

    def submit(self, job_id: str, step: int, tree,
               meta: Optional[dict] = None, *, fused: bool = False) -> None:
        """Copy ``tree`` to host now; write it to disk in the background.
        Returns after the host copy is complete."""
        flat = snapshot_to_host(tree, fused=fused)
        with self._lock:
            self.pending += 1
        self._q.put((job_id, step, flat, meta))
        self._ensure_worker()

    def barrier(self) -> None:
        """Block until every submitted write is fully published.

        After this returns, ``store.latest_step`` names a complete
        checkpoint — the preempt path calls this before releasing slots.
        Re-raises the first background write error, if any."""
        self._q.join()
        with self._lock:
            if self._errors:
                raise self._errors.pop(0)

    def close(self) -> None:
        self.barrier()
        if self._worker is not None and self._worker.is_alive():
            self._q.put(None)
            self._worker.join(timeout=5.0)
            self._worker = None
