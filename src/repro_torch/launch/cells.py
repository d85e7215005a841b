"""Cell definitions: (architecture x input shape) -> traceable step
functions with their sharding specs, per-arch sharding-rule selection and
MODEL_FLOPS (counterpart of ``repro.launch.cells``).

The reference lowers each cell's jitted step on a TPU mesh.  The port has no
XLA and runs on one card: ``Cell.trace`` runs the cell's step on meta
tensors at the full published size, under ``utils.memtrace.MemTracker``
(live bytes; the stand-in for ``memory_analysis``) and
``torch.utils.flop_counter.FlopCounterMode`` (the stand-in for
``cost_analysis``).  The sharding specs give each argument's per-device
shape on any mesh shape (``sharding.shard_shape``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.checkpoint.reshard import tree_leaves, tree_map
from repro_torch.configs import get_config, list_archs, shape_applicable
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      count_active_params)
from repro_torch.models import model as M
from repro_torch.optim import (AdamWConfig, abstract_opt_state, adamw_update,
                               opt_logical_axes, warmup_cosine)
from repro_torch.sharding import (RULE_SETS, AxisRules, axis_rules,
                                  make_param_shardings)
from repro_torch.utils.memtrace import MemTracker

# ---------------------------------------------------------------------------
# Per-arch sharding rules (the reference's baseline)
# ---------------------------------------------------------------------------

# FSDP for archs whose optimizer state cannot replicate over 'data'
_FSDP_ARCHS = {"deepseek-v2-236b", "jamba-v0.1-52b", "chameleon-34b",
               "yi-9b"}
# sequence parallelism applies to all archs
_NO_SP_ARCHS = set()

# per-arch logical->mesh overrides applied on top of the rule set: >30B
# params cannot replicate over 'data' even when serving, so the FSDP embed
# sharding stays in the decode/prefill rules too
ARCH_OVERRIDES: Dict[str, Dict[str, object]] = {
    "deepseek-v2-236b": {"embed": ("pod", "data")},
    "jamba-v0.1-52b": {"embed": ("pod", "data")},
    "chameleon-34b": {"embed": ("pod", "data")},
}


def train_rules_name(arch: str) -> str:
    fsdp = arch in _FSDP_ARCHS
    sp = arch not in _NO_SP_ARCHS
    return {
        (False, False): "tp",
        (False, True): "tp_sp",
        (True, False): "tp_fsdp",
        (True, True): "tp_fsdp_sp",
    }[(fsdp, sp)]


def decode_rules_name(arch: str, shape: ShapeConfig) -> str:
    return "decode_long" if shape.name == "long_500k" else "decode"


def make_rules(arch: str, mesh, name: str,
               extra_overrides: Optional[dict] = None) -> AxisRules:
    rules = RULE_SETS[name]()
    rules.update(ARCH_OVERRIDES.get(arch, {}))
    rules.update(extra_overrides or {})
    return AxisRules(mesh=mesh, rules=rules)


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------

def build_train_step(cfg: ModelConfig, adamw: AdamWConfig = AdamWConfig(),
                     total_steps: int = 10_000) -> Callable:
    """The port's ``loss_fn`` over the whole global batch, its backward and
    an in-place AdamW step at ``warmup_cosine``'s rate.  ``params`` are
    leaves that take a gradient; they and ``opt_state`` are updated in
    place and returned (the reference's donated arguments)."""
    def train_step(params, opt_state, batch, step):
        loss, metrics = M.loss_fn(cfg, params, batch)
        loss.backward()
        lr = warmup_cosine(step, peak_lr=3e-4, warmup_steps=500,
                           total_steps=total_steps)
        om = adamw_update(adamw, tree_map(lambda p: p.grad, params), opt_state,
                          params, lr)
        for p in tree_leaves(params):
            p.grad = None
        return params, opt_state, dict(metrics, **om)
    return train_step


def build_prefill(cfg: ModelConfig) -> Callable:
    def prefill_step(params, batch):
        return M.prefill(cfg, params, batch)
    return prefill_step


def build_decode_step(cfg: ModelConfig, at: int) -> Callable:
    """One decode step writing the cache in place.  ``pos`` is the int32
    position tensor of the reference's signature; a meta tensor has no
    value, so a trace decodes at ``at`` (the cell's last position: the
    attention reads the whole cache)."""
    def decode(params, cache, tokens, pos):
        p = at if pos.is_meta else int(pos)
        return M.decode_step(cfg, params, cache, tokens, p)
    return decode


# ---------------------------------------------------------------------------
# Cell assembly
# ---------------------------------------------------------------------------

def _tensors(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _storages(tensors) -> dict:
    """{storage id: bytes} of the distinct storages of ``tensors``."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes() for t in tensors}


@dataclass
class Trace:
    """What one meta run of a cell's step showed (bytes on one device)."""
    entry_bytes: int        # live at entry: the arguments, rounded as tracked
    peak_bytes: int         # most live at once, entry included
    output_bytes: int       # every output's storage
    alias_bytes: int        # outputs that are arguments updated in place
    flops: float            # FlopCounterMode's count plus the kernels' notes
    kernel_flops: Dict[str, int]
    bytes_accessed: int     # every op's operand and result bytes
    seconds: float


@dataclass
class Cell:
    arch: str
    cfg: ModelConfig
    shape: ShapeConfig
    rules: AxisRules
    fn: Callable
    abstract_args: tuple
    in_shardings: tuple
    donate: Tuple[int, ...]
    model_flops: float          # MODEL_FLOPS for one step of this cell
    scan_trips: Dict[str, int]  # stacked blocks a step runs

    def trace(self, device: str = "meta") -> Trace:
        """Run ``fn`` once on ``abstract_args`` under the live-bytes tracker
        and a FLOP counter.  ``device`` names the device type the arguments
        lie on and the tracker counts: meta (the dry-run), or cuda, where
        ``abstract_args`` were replaced by real tensors."""
        args = _tensors(self.abstract_args)
        t0 = time.perf_counter()
        with axis_rules(self.rules), MemTracker(device, entry=args) as mt, \
                FlopCounterMode(display=False) as fc:
            out = self.fn(*self.abstract_args)
        seconds = time.perf_counter() - t0
        outs = _storages(_tensors(out))
        ins = _storages(args)
        return Trace(entry_bytes=mt.entry_bytes, peak_bytes=mt.peak_bytes,
                     output_bytes=sum(outs.values()),
                     alias_bytes=sum(n for k, n in outs.items() if k in ins),
                     flops=float(fc.get_total_flops() + sum(mt.kernel_flops.values())),
                     kernel_flops=dict(mt.kernel_flops),
                     bytes_accessed=mt.bytes_accessed, seconds=seconds)


def _model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    # 6*N_active*D (train) / 2*N_active*D (inference); for enc-dec, D counts
    # decoder tokens only
    n_active = count_active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch      # one token per sequence


def _batch_sharding(rules: AxisRules, spec_tree):
    def sh(s):
        axes = ("batch",) + (None,) * (s.dim() - 1)
        return rules.spec_for(axes, tuple(s.shape))
    return tree_map(sh, spec_tree)


def make_cell(arch: str, shape_name: str, mesh, *,
              rules_name: Optional[str] = None,
              rule_overrides: Optional[dict] = None,
              cfg_override: Optional[ModelConfig] = None) -> Cell:
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} x {shape_name}: {why}")

    prefix_n, scan_n = cfg.scan_layers()
    period = cfg.layer_period()
    trips = {"while": max(1, scan_n // period)}
    axes = M.logical_axes(cfg)
    abstract_p = M.abstract_params(cfg)

    if shape.kind == "train":
        rname = rules_name or train_rules_name(arch)
        rules = make_rules(arch, mesh, rname, rule_overrides)
        abstract_o = abstract_opt_state(abstract_p)
        for p in tree_leaves(abstract_p):
            p.requires_grad_()
        p_sh = make_param_shardings(rules, axes, abstract_p)
        o_sh = make_param_shardings(rules, opt_logical_axes(axes), abstract_o)
        batch_spec = M.input_specs(cfg, shape)
        b_sh = _batch_sharding(rules, batch_spec)
        step = torch.empty((), dtype=torch.int32, device="meta")
        return Cell(arch, cfg, shape, rules, build_train_step(cfg),
                    (abstract_p, abstract_o, batch_spec, step),
                    (p_sh, o_sh, b_sh, ()), (0, 1),
                    _model_flops(cfg, shape), trips)

    rname = rules_name or decode_rules_name(arch, shape)
    rules = make_rules(arch, mesh, rname, rule_overrides)
    p_sh = make_param_shardings(rules, axes, abstract_p)

    if shape.kind == "prefill":
        batch_spec = M.input_specs(cfg, shape)
        b_sh = _batch_sharding(rules, batch_spec)
        return Cell(arch, cfg, shape, rules, build_prefill(cfg),
                    (abstract_p, batch_spec), (p_sh, b_sh), (),
                    _model_flops(cfg, shape), trips)

    # decode
    spec = M.input_specs(cfg, shape)
    c_sh = make_param_shardings(rules, M.cache_axes(cfg), spec["cache"])
    tok_sh = rules.spec_for(("batch", None), tuple(spec["tokens"].shape))
    return Cell(arch, cfg, shape, rules, build_decode_step(cfg, shape.seq_len - 1),
                (abstract_p, spec["cache"], spec["tokens"], spec["pos"]),
                (p_sh, c_sh, tok_sh, ()), (1,),
                _model_flops(cfg, shape), trips)


def all_cells() -> list:
    """All (arch x shape) pairs with skip annotations."""
    out = []
    for arch in list_archs():
        cfg = get_config(arch)
        for sname in SHAPES:
            ok, why = shape_applicable(cfg, SHAPES[sname])
            out.append((arch, sname, ok, why))
    return out


__all__ = ["Cell", "Trace", "make_cell", "all_cells", "make_rules",
           "train_rules_name", "decode_rules_name", "build_train_step",
           "build_prefill", "build_decode_step", "ARCH_OVERRIDES"]
