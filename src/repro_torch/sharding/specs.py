"""Logical-axis sharding rules (counterpart of ``repro.sharding.specs``).

Every parameter, optimizer moment, cache leaf and input carries *logical*
axis names (``'embed'``, ``'heads'``, ``'ffn'``, ``'experts'``,
``'batch'``, ...).  An :class:`AxisRules` maps logical names to mesh axes,
shape-aware exactly as the reference's does.  The port places no tensor on
a mesh: it runs on one card.  The rules give the dry-run each leaf's
per-device shape on any mesh shape (``shard_shape``), so argument bytes are
exact on the reference's 16x16 and 2x16x16 meshes as on the card's 1x1.

A spec is a plain tuple, the counterpart of ``PartitionSpec``: each entry is
``None``, a mesh axis name, or a tuple of mesh axis names.  A mesh is any
object with ``axis_names`` and a ``shape`` mapping of axis name to size
(``launch.mesh.MeshShape``), the two attributes the reference reads.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]


@dataclass
class AxisRules:
    """mesh + logical->mesh mapping.  ``mesh=None`` disables all constraints.

    ``spec_for`` is *shape-aware*: a mesh axis is only assigned to a tensor
    dimension when the dimension size is divisible by it.  Indivisible dims
    fall back to a divisible prefix of the requested axis tuple, or
    replication, and the freed mesh axis stays available for a later logical
    axis (when 4 kv_heads cannot shard 16-way, the 'qk' head_dim rule picks
    up 'model' instead)."""
    mesh: Optional[Any] = None
    rules: Dict[str, MeshAxes] = field(default_factory=dict)

    def spec_for(self, logical: Tuple[Optional[str], ...],
                 shape: Optional[Tuple[int, ...]] = None) -> Spec:
        out = []
        used = set()
        for i, name in enumerate(logical):
            ax = self.rules.get(name) if name else None
            if ax is None:
                out.append(None)
                continue
            axs = (ax,) if isinstance(ax, str) else tuple(ax)
            # a mesh axis may appear at most once in a spec
            axs = tuple(a for a in axs
                        if a not in used and a in self.mesh.axis_names)
            if shape is not None:
                # keep the longest prefix whose size product divides the dim
                dim = shape[i]
                kept = []
                prod = 1
                for a in axs:
                    n = self.mesh.shape[a]
                    if dim % (prod * n) == 0:
                        kept.append(a)
                        prod *= n
                    else:
                        break
                axs = tuple(kept)
            used.update(axs)
            if not axs:
                out.append(None)
            elif len(axs) == 1:
                out.append(axs[0])
            else:
                out.append(axs)
        return tuple(out)


_STATE = threading.local()


def current_rules() -> Optional[AxisRules]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def axis_rules(rules: Optional[AxisRules]):
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        yield rules
    finally:
        _STATE.rules = prev


def shard_constraint(x, *logical: Optional[str]):
    """Annotate activation ``x`` with logical axes: ``x`` itself.  On one card
    there is nothing to constrain, the reference's own path without a mesh;
    no model of the port calls it."""
    return x


def rule_axis_size(logical: str) -> int:
    """Product of mesh-axis sizes the current rules map ``logical`` to
    (1 when no rules are active or the name is unmapped)."""
    r = current_rules()
    if r is None or r.mesh is None:
        return 1
    ax = r.rules.get(logical)
    if ax is None:
        return 1
    axs = (ax,) if isinstance(ax, str) else tuple(ax)
    prod = 1
    for a in axs:
        if a in r.mesh.axis_names:
            prod *= r.mesh.shape[a]
    return prod


def can_shard(n: int, logical: str) -> bool:
    """Whether dim size ``n`` divides the mesh axes the current rules map
    ``logical`` to (False when no rules are active)."""
    prod = rule_axis_size(logical)
    return prod > 1 and n % prod == 0


def logical_to_spec(rules: AxisRules, logical: Tuple[Optional[str], ...],
                    shape=None) -> Spec:
    return rules.spec_for(tuple(logical), shape)


def is_axes_leaf(x) -> bool:
    """A logical-axes tuple (the leaves of an axes tree)."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def _shape_of(s) -> Tuple[int, ...]:
    return tuple(s.shape) if hasattr(s, "shape") else tuple(s)


def _map(fn, tree, *rest):
    """``fn`` over the axes leaves of the nested-dict ``tree`` and the
    matching leaves of the trees in ``rest``."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def make_param_shardings(rules: AxisRules, logical_tree, shape_tree=None):
    """Nested dict of logical-axes tuples (and an optional parallel tree of
    shapes or tensors) -> the same tree of specs; of ``None`` without a
    mesh, the reference's answer there."""
    if rules.mesh is None:
        return _map(lambda _: None, logical_tree)
    if shape_tree is None:
        return _map(rules.spec_for, logical_tree)
    return _map(lambda a, s: rules.spec_for(a, _shape_of(s)), logical_tree,
                shape_tree)


def shard_shape(spec: Spec, shape: Tuple[int, ...], mesh) -> Tuple[int, ...]:
    """The per-device shape of a ``shape`` array laid out by ``spec`` on
    ``mesh`` (the counterpart of ``NamedSharding.shard_shape``): each
    dimension divided by the product of its mesh axes' sizes, which must
    divide it."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, spec):
        axs = () if entry is None else (entry,) if isinstance(entry, str) else entry
        n = 1
        for a in axs:
            n *= mesh.shape[a]
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide over "
                             f"{axs} ({n} devices)")
        out.append(dim // n)
    return tuple(out)


# ---------------------------------------------------------------------------
# Rule sets (the reference's seven)
# ---------------------------------------------------------------------------
# Logical axes used by the model zoo:
#   batch, seq            activations
#   embed, embed2         residual/model dim (embed2 = second embed-sized dim)
#   heads, kv_heads, qk   attention projections
#   ffn                   dense-FFN hidden
#   vocab                 embedding / lm-head vocab dim
#   experts, expert_ffn   MoE
#   lora                  MLA low-rank dims
#   ssm_inner, ssm_state, ssm_heads
#   layers                stacked leading axis (never sharded)
#   cache_seq             KV-cache sequence dim

def _base_rules() -> Dict[str, MeshAxes]:
    return {
        "layers": None,
        "batch": ("pod", "data"),
        "seq": None,
        "embed": None,
        "embed2": None,
        "heads": "model",
        "kv_heads": "model",
        # fallback: when heads/kv_heads cannot shard (indivisible), the
        # head_dim picks up 'model' (shape-aware spec_for drops used axes)
        "qk": "model",
        "ffn": "model",
        "vocab": "model",
        "experts": "model",
        "expert_ffn": None,
        "expert_cap": None,
        "lora": None,
        "ssm_inner": "model",
        "ssm_state": None,
        "ssm_heads": "model",
        "cache_seq": None,
        "cache_batch": ("pod", "data"),
    }


def rules_tp() -> Dict[str, MeshAxes]:
    """Pure tensor-parallel over 'model'; params replicated over 'data'."""
    return _base_rules()


def rules_tp_fsdp() -> Dict[str, MeshAxes]:
    """TP over 'model' + FSDP of params over ('pod','data') on the embed dim
    (the >30B archs' parameters do not fit replicated)."""
    r = _base_rules()
    r.update(embed=("pod", "data"))
    return r


def rules_tp_sp() -> Dict[str, MeshAxes]:
    """TP + sequence parallelism: residual-stream activations sharded over
    'model' on the sequence dim between layers."""
    r = _base_rules()
    r.update(seq="model")
    return r


def rules_tp_fsdp_sp() -> Dict[str, MeshAxes]:
    r = rules_tp_fsdp()
    r.update(seq="model")
    return r


def rules_decode() -> Dict[str, MeshAxes]:
    """Serving: KV cache batch-sharded over ('pod','data') and sequence-
    sharded over 'model' (context parallelism).  cache_seq claims 'model'
    first on self-attention caches (batch, seq, kv, hd), so kv_heads keeps
    'model' for a cache without a cache_seq dim (seamless's cross cache)."""
    r = _base_rules()
    r.update(cache_seq="model")
    return r


def rules_decode_long() -> Dict[str, MeshAxes]:
    """long_500k (batch 1): the data axis is idle for batch, so the KV cache
    sequence shards over BOTH ('data','model')."""
    r = rules_decode()
    r.update(cache_seq=("data", "model"))
    return r


def rules_decode_batch_model() -> Dict[str, MeshAxes]:
    """Serving for few-kv-head archs: shard cache batch over everything,
    replicate the weights' head dims."""
    r = _base_rules()
    r.update(batch=("pod", "data", "model"),
             cache_batch=("pod", "data", "model"),
             heads=None, kv_heads=None, ffn=None, vocab=None,
             ssm_inner=None, ssm_heads=None, experts=None)
    return r


RULE_SETS = {
    "tp": rules_tp,
    "tp_fsdp": rules_tp_fsdp,
    "tp_sp": rules_tp_sp,
    "tp_fsdp_sp": rules_tp_fsdp_sp,
    "decode": rules_decode,
    "decode_long": rules_decode_long,
    "decode_batch_model": rules_decode_batch_model,
}


def rules_for(name: str, mesh) -> AxisRules:
    return AxisRules(mesh=mesh, rules=RULE_SETS[name]())
