"""Disk checkpoints: copy of ``repro.checkpoint.disk.DiskCheckpointStore``
over the port's snapshot, with the same on-disk format.

Each save writes an ``.npz`` of the leaves it must write plus a json manifest
(``step``, sorted ``keys``, per-leaf ``{"file","slot","hash"}`` entries,
``meta``), both staged through ``tempfile.mkstemp`` and published with
``os.replace``.  ``delta=True`` rewrites only leaves whose blake2b hash
changed since the previous manifest and references the rest, so delta chains
and checkpoints load in both directions between the JAX package and the port.

A bfloat16 leaf is held as ``V2`` bits (``reshard.host_array``): the npz file
stores it as the JAX package's does, its hash names the dtype ``bfloat16`` as
the JAX package's hash of the ``ml_dtypes`` leaf does, and ``load`` returns
it as ``V2``.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.reshard import is_bf16_host, snapshot_to_host


def _leaf_hash(arr: np.ndarray) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(("bfloat16" if is_bf16_host(arr) else str(arr.dtype)).encode())
    h.update(str(arr.shape).encode())
    h.update(np.ascontiguousarray(arr).view(np.uint8).data)
    return h.hexdigest()


def _unlink_quietly(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


class DiskCheckpointStore:
    def __init__(self, root: str):
        self.root = root
        self.last_bytes_written = 0     # npz payload of the latest save
        os.makedirs(root, exist_ok=True)

    def _dir(self, job_id: str) -> str:
        d = os.path.join(self.root, job_id)
        os.makedirs(d, exist_ok=True)
        return d

    def _manifest_path(self, d: str, step: int) -> str:
        return os.path.join(d, f"step_{step:09d}.json")

    def save(self, job_id: str, step: int, tree,
             meta: Optional[dict] = None, *, delta: bool = False,
             fused: bool = False) -> float:
        flat = snapshot_to_host(tree, fused=fused)
        return self.save_flat(job_id, step, flat, meta, delta=delta)

    def save_flat(self, job_id: str, step: int, flat: Dict[str, np.ndarray],
                  meta: Optional[dict] = None, *, delta: bool = False
                  ) -> float:
        """Write an already host-resident ``{path-key: ndarray}`` snapshot."""
        t0 = time.perf_counter()
        d = self._dir(job_id)
        keys = sorted(flat.keys())
        npz_name = f"step_{step:09d}.npz"

        prev_leaves: Dict[str, dict] = {}
        if delta:
            prev_step = self.latest_step(job_id)
            if prev_step is not None and prev_step != step:
                with open(self._manifest_path(d, prev_step)) as f:
                    prev_leaves = self._leaf_index(json.load(f))
        leaves: Dict[str, dict] = {}
        to_write = []                       # (slot, key) pairs for OUR npz
        for k in keys:
            h = _leaf_hash(np.asarray(flat[k]))
            prev = prev_leaves.get(k)
            if prev is not None and prev.get("hash") == h:
                leaves[k] = dict(prev)      # cold leaf: point at old file
            else:
                slot = f"a{len(to_write)}"
                to_write.append((slot, k))
                leaves[k] = {"file": npz_name, "slot": slot, "hash": h}

        fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
        try:
            # write via the open fd: np.savez appends ".npz" to a bare path
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **{slot: flat[k] for slot, k in to_write})
        except BaseException:
            _unlink_quietly(tmp)
            raise
        self.last_bytes_written = os.path.getsize(tmp)
        os.replace(tmp, os.path.join(d, npz_name))

        manifest = {"step": step, "keys": keys, "leaves": leaves,
                    "meta": meta or {}, "saved_at": time.time(),
                    "delta": bool(prev_leaves),
                    "bytes_written": self.last_bytes_written}
        mfd, mtmp = tempfile.mkstemp(dir=d, suffix=".json.tmp")
        try:
            with os.fdopen(mfd, "w") as f:
                json.dump(manifest, f)
            os.replace(mtmp, self._manifest_path(d, step))
        except BaseException:
            _unlink_quietly(mtmp)
            raise
        return time.perf_counter() - t0

    @staticmethod
    def _leaf_index(manifest: dict) -> Dict[str, dict]:
        """key -> {"file","slot","hash"}; manifests without ``leaves`` map key
        i to slot ``a{i}`` of their own npz."""
        if "leaves" in manifest:
            return manifest["leaves"]
        npz = f"step_{manifest['step']:09d}.npz"
        return {k: {"file": npz, "slot": f"a{i}", "hash": None}
                for i, k in enumerate(manifest["keys"])}

    def latest_step(self, job_id: str) -> Optional[int]:
        d = os.path.join(self.root, job_id)
        if not os.path.isdir(d):
            return None
        steps = [int(f[5:-5]) for f in os.listdir(d)
                 if f.startswith("step_") and f.endswith(".json")]
        return max(steps) if steps else None

    def load(self, job_id: str, step: Optional[int] = None
             ) -> Tuple[Dict[str, np.ndarray], dict]:
        step = self.latest_step(job_id) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint for {job_id}")
        d = os.path.join(self.root, job_id)
        with open(self._manifest_path(d, step)) as f:
            manifest = json.load(f)
        leaves = self._leaf_index(manifest)
        flat: Dict[str, np.ndarray] = {}
        by_file: Dict[str, list] = {}
        for k in manifest["keys"]:
            by_file.setdefault(leaves[k]["file"], []).append(k)
        for fname, ks in by_file.items():       # open each referenced npz once
            with np.load(os.path.join(d, fname)) as z:
                for k in ks:
                    flat[k] = z[leaves[k]["slot"]]
        return flat, manifest

    def nbytes_on_disk(self, job_id: str) -> int:
        d = os.path.join(self.root, job_id)
        if not os.path.isdir(d):
            return 0
        return sum(os.path.getsize(os.path.join(d, f))
                   for f in os.listdir(d) if f.endswith(".npz"))
