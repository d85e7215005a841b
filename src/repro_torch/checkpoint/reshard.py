"""Flat path keys, host snapshots and restores of the port's state trees.

Counterpart of ``repro.checkpoint.reshard``.  The port's trees are nested
dicts whose leaves are tensors (or numpy arrays); ``flatten_tree`` walks them
in sorted key order, as ``jax.tree_util`` walks a dict, and joins the keys
with ``/``, escaping a literal ``%`` or ``/`` inside a key exactly as the
reference does, so the flat keys of the two packages are equal.

``snapshot_to_host`` always COPIES into host memory (pinned for CUDA
tensors).  The reference may hand out views because JAX arrays are
immutable; the port's optimizer updates tensors in place, so a ``.numpy()``
view of a CPU tensor would change under the snapshot.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch


def _escape(part: str) -> str:
    return part.replace("%", "%25").replace("/", "%2F")


def _unescape(part: str) -> str:
    return part.replace("%2F", "/").replace("%25", "%")


def tree_path_keys(tree, _prefix: str = "") -> List[Tuple[str, object]]:
    """[(stable 'a/b/c' key, leaf)] in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_path_keys(tree[k], f"{_prefix}{_escape(str(k))}/"))
        return out
    return [(_prefix[:-1], tree)]


def flatten_tree(tree) -> Dict[str, object]:
    """nested dict -> flat {'a/b/c': leaf} dict (stable, path-keyed)."""
    return dict(tree_path_keys(tree))


def unflatten_tree(template, flat: Dict[str, object]):
    """Rebuild a nested dict shaped like ``template`` from a flat dict."""
    return _build(template, flat, "")


def _build(node, flat: Dict[str, object], path: str):
    # a module-level function: a recursive closure would be a reference cycle
    # holding ``flat``, and with it every leaf, until the garbage collector ran
    if isinstance(node, dict):
        return {k: _build(v, flat, f"{path}{_escape(str(k))}/")
                for k, v in node.items()}
    return flat[path[:-1]]


def nest_flat(flat: Dict[str, object]) -> dict:
    """Flat {'a/b/c': leaf} -> nested dict, without a template."""
    tree: dict = {}
    for key, leaf in flat.items():
        parts = [_unescape(p) for p in key.split("/")]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_path_keys(tree)]


# numpy has no bfloat16 without ``ml_dtypes``, which the port does not use: a
# bfloat16 leaf's numpy form is a 2-byte void view of its bits, the form in
# which the JAX package's npz files already hold such a leaf
BF16_HOST = np.dtype("V2")


def is_bf16_host(arr: np.ndarray) -> bool:
    """True for the host form of a bfloat16 leaf: a plain 2-byte void array
    (``V2``, as an npz file returns it) or an ``ml_dtypes.bfloat16`` array,
    whose dtype is of kind ``V`` too."""
    return arr.dtype.kind == "V" and arr.dtype.itemsize == 2 \
        and arr.dtype.fields is None


def host_array(t: torch.Tensor) -> np.ndarray:
    """numpy view of a CPU tensor (no copy); a bfloat16 tensor comes back as
    a ``V2`` view of its bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_HOST)
    return t.numpy()


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """CPU tensor over a host array's memory (no copy): the inverse of
    ``host_array``.  A bfloat16 host leaf (``is_bf16_host``) becomes a
    ``torch.bfloat16`` tensor of the same bits; any other void dtype is
    refused."""
    if arr.dtype.kind == "V":
        if not is_bf16_host(arr):
            raise TypeError(f"numpy dtype {arr.dtype} is not a bfloat16 leaf")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _copy_to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    host.copy_(t)
    return host_array(host)


def snapshot_to_host(tree, *, fused: bool = False) -> Dict[str, np.ndarray]:
    """Device -> host-RAM copy of ``tree`` as ``{path-key: ndarray}``.

    ``fused=True`` routes the copies through the pack kernel
    (``repro_torch.kernels.pack``): one packed buffer and one host copy per
    dtype group instead of one copy per leaf."""
    flat = flatten_tree(tree)
    if fused:
        from repro_torch.kernels.pack import packed_snapshot_to_host
        return packed_snapshot_to_host(
            {k: torch.as_tensor(v) for k, v in flat.items()})
    return {k: _copy_to_host(torch.as_tensor(v)) for k, v in flat.items()}


def restore_from_host(host_flat: Dict[str, np.ndarray], template,
                      device: torch.device):
    """Host snapshot -> new tensors on ``device``, shaped like ``template``;
    each leaf keeps the template leaf's dtype and ``requires_grad``.  Always
    a copy, so later in-place updates never write into the snapshot."""
    def put(leaf, arr):
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape {arr.shape} does not fit {tuple(leaf.shape)}")
        t = host_tensor(arr).to(device=device, dtype=leaf.dtype, copy=True)
        return t.requires_grad_(leaf.requires_grad)
    keys = tree_path_keys(template)
    flat = {k: put(leaf, host_flat[k]) for k, leaf in keys}
    return unflatten_tree(template, flat)


def surviving_devices(old: Sequence, new: Sequence) -> int:
    """How many of the OLD slots survive into the NEW set: the condition under
    which a rescale can keep state resident and skip the host round-trip."""
    new_ids = {d.id for d in new}
    return sum(1 for d in old if d.id in new_ids)
