"""Dry-run: trace every (arch x shape) cell on the meta device and extract
roofline inputs (counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each cell on a TPU mesh and reads XLA's
memory and cost analyses.  The port has no XLA and places nothing on a
mesh; per cell:

  1. argument bytes, exact on any mesh shape: the sum of the per-device
     shard bytes of the parameters, the optimizer state, the batch or the
     cache and the step, from the sharding rules (``sharding.shard_shape``);
     ``alias_bytes``, the part updated in place (parameters and optimizer
     state in train, the cache in decode), the same way.
  2. on ``card_1x1`` (one H100): the step traced on meta tensors at the
     full published size (``Cell.trace``): the live-bytes tracker gives the
     peak, and with it ``temp_bytes`` by the reference's formula (peak =
     argument + output + temp - alias); ``FlopCounterMode`` and the kernel
     wrappers' notes give ``traced_cost`` (the counterpart of ``xla_cost``);
     there are no collectives on one card.  ``fits_hbm``: the peak within
     the card's 80 GB.
  3. on a mesh of more than one device the port has no partitioned program:
     temp, peak, output bytes, ``traced_cost``, collectives and the roofline
     are null, never guessed, and ``fits_hbm_arguments`` holds the argument
     bytes to 80 GB.
  4. FLOPs and HBM traffic from the analytic models (``utils.flops``) and,
     on the card, the H100 roofline (``utils.roofline``).

It traces on meta and needs no card.  Results accumulate in a JSON file
(default ``results/dryrun_torch.json``), resumable with --skip-existing.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh card_1x1 [--skip-existing]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

CARD_HBM_BYTES = 80e9       # NVIDIA H100 80GB HBM3


def _cell_key(arch: str, shape: str, mesh_name: str, rules: str = "") -> str:
    return f"{arch}|{shape}|{mesh_name}" + (f"|{rules}" if rules else "")


def shard_bytes(tensors, specs, mesh) -> int:
    """Per-device bytes of ``tensors`` laid out by the parallel tree
    ``specs`` on ``mesh``."""
    from repro_torch.sharding import shard_shape
    if isinstance(tensors, dict):
        return sum(shard_bytes(tensors[k], specs[k], mesh) for k in tensors)
    return math.prod(shard_shape(specs, tuple(tensors.shape), mesh)) * tensors.element_size()


def argument_bytes(cell, mesh) -> tuple:
    """(argument bytes, alias bytes) per device of ``cell`` on ``mesh``."""
    per_arg = [shard_bytes(a, s, mesh) for a, s in
               zip(cell.abstract_args, cell.in_shardings)]
    return sum(per_arg), sum(per_arg[i] for i in cell.donate)


def run_cell(arch: str, shape_name: str, *, mesh_name: str = "card_1x1",
             rules_name=None, rule_overrides=None) -> dict:
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.cells import (decode_rules_name, make_cell,
                                          train_rules_name)
    from repro_torch.launch.mesh import MESHES, chips_in
    from repro_torch.utils.flops import cell_flops, cell_hbm_bytes
    from repro_torch.utils.roofline import roofline_from_analysis

    mesh = MESHES[mesh_name]()
    chips = chips_in(mesh)
    shape = SHAPES[shape_name]
    eff_rules = rules_name or (train_rules_name(arch) if shape.kind == "train"
                               else decode_rules_name(arch, shape))
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "chips": chips, "rules": eff_rules, "status": "ok"}

    cell = make_cell(arch, shape_name, mesh, rules_name=rules_name,
                     rule_overrides=rule_overrides)
    arg, alias = argument_bytes(cell, mesh)
    flops_global = cell_flops(cell.cfg, shape)
    hbm_global = cell_hbm_bytes(cell.cfg, shape)
    rec["model_flops"] = cell.model_flops
    rec["analytic"] = {"flops_global": flops_global,
                       "hbm_bytes_global": hbm_global}
    if chips > 1:
        rec["memory"] = {"argument_bytes": arg, "output_bytes": None,
                         "temp_bytes": None, "alias_bytes": alias,
                         "peak_bytes": None}
        rec["fits_hbm_arguments"] = arg <= CARD_HBM_BYTES
        rec["traced_cost"] = None
        rec["collectives"] = None
        rec["roofline"] = None
        return rec

    tr = cell.trace()
    rec["trace_s"] = round(tr.seconds, 1)
    out = tr.output_bytes
    temp = max(0, tr.peak_bytes - tr.entry_bytes - (out - tr.alias_bytes))
    rec["memory"] = {"argument_bytes": arg, "output_bytes": out,
                     "temp_bytes": temp, "alias_bytes": alias,
                     "peak_bytes": arg + out + temp - alias}
    rec["fits_hbm"] = rec["memory"]["peak_bytes"] <= CARD_HBM_BYTES
    rec["traced_cost"] = {"flops": tr.flops, "bytes": tr.bytes_accessed,
                          "kernel_flops": tr.kernel_flops}
    rec["collectives"] = {"total": 0}
    terms = roofline_from_analysis(
        {"flops": flops_global / chips, "bytes accessed": hbm_global / chips},
        0.0, cell.model_flops, chips)
    rec["roofline"] = terms.as_dict()
    return rec


def skipped_records() -> dict:
    """The reference's records of the cells that do not apply."""
    from repro_torch.launch.cells import all_cells
    return {_cell_key(a, s, "skipped"): {"arch": a, "shape": s, "status": "skipped",
                                         "reason": why}
            for a, s, ok, why in all_cells() if not ok}


def main(argv=None):
    from repro_torch.launch.mesh import MESHES
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--rules", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="card_1x1", choices=sorted(MESHES))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    from repro_torch.launch.cells import all_cells

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    if args.all:
        targets = [(a, s) for a, s, ok, _ in all_cells() if ok]
    else:
        targets = [(args.arch, args.shape)]
    results.update(skipped_records())

    for arch, shape in targets:
        key = _cell_key(arch, shape, args.mesh, args.rules or "")
        if args.skip_existing and results.get(key, {}).get("status") == "ok":
            print(f"[skip] {key}", flush=True)
            continue
        print(f"[run ] {key}", flush=True)
        t0 = time.time()
        try:
            rec = run_cell(arch, shape, mesh_name=args.mesh, rules_name=args.rules)
        except Exception as e:      # a failed cell is recorded; the rest run on
            rec = {"arch": arch, "shape": shape, "mesh": args.mesh,
                   "status": "error", "error": repr(e),
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"[FAIL] {key}: {e!r}", flush=True)
        rec["wall_s"] = round(time.time() - t0, 1)
        results[key] = rec
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, sort_keys=True)
        if rec.get("status") == "ok":
            mem = rec["memory"]
            if rec["chips"] > 1:
                print(f"   ok args={mem['argument_bytes'] / 1e9:.2f}GB/chip "
                      f"fits_args={rec['fits_hbm_arguments']} ({rec['wall_s']}s)",
                      flush=True)
                continue
            rl = rec["roofline"]
            print(f"   ok mem={mem['peak_bytes'] / 1e9:.2f}GB/chip "
                  f"fits={rec['fits_hbm']} bottleneck={rl['bottleneck']} "
                  f"useful={rl['useful_flops_fraction']:.2f} "
                  f"mfu_bound={rl['mfu_bound']:.3f} ({rec['wall_s']}s)", flush=True)
    return results


if __name__ == "__main__":
    main()
