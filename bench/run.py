#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (imports, the kernels' build or load,
the weights drawn on the card from the seed, the warm-up steps) counts as
``setup_s``; the window then measures for ``--seconds``; once it has
closed, the reference follows the compared steps and decides ``correct``.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit,
which also end standard error.  Without a card, or with fewer cards than
the cell asks for, it exits 2 and prints no result; with JAX or the JAX
package loaded once the window has closed, it exits 3.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def loaded_forbidden():
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: ``repro_torch`` is not ``repro``)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def result(spec, out, bench, cell, traced, device_name):
    metrics = {}
    for m in spec.metrics_for(bench, cell["name"], traced):
        value = spec.reader(m["name"]).read(out)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_name, "count": cell["chips"],
              "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if traced:
        device.update(busy_s=out.trace["busy_s"], window_s=out.trace["window_s"])
        line["breakdown"] = {"device_ops": out.trace["device_ops"],
                             "idle_gaps": out.trace["idle_gaps"]}
    line["checks"] = out.checks
    return line


def use_checkout():
    """The kernels' caches inside the checkout, at fixed paths, and the
    checkout's benchmark and port on the path."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "bench", "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "bench", "build", "torch_ext")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main(argv=None) -> int:
    args = parse(argv)
    use_checkout()
    from bench import spec
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("bench: no CUDA card is available; the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"bench: {cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"bench: the port (src/repro_torch) is not in this checkout: {e}",
              file=sys.stderr)
        return 2
    cfg = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    out = spec.driver(traffic["driver"]).run(
        cell, cfg, traffic, spec.limits(cell["name"]), seed=args.seed,
        seconds=args.seconds, traced=bool(args.trace), device="cuda", t_start=T_START)
    found = loaded_forbidden()
    if found:
        print(f"bench: JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return 3
    out.device_name = torch.cuda.get_device_name(0)
    line = result(spec, out, bench, cell, bool(args.trace), out.device_name)
    import resource
    from repro_torch.kernels import ops
    out.log["host_max_rss_gb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(json.dumps({"launches": ops.launch_counts_by_dtype(),
                      "reference_s": out.reference_s, "trace_reduce_s": out.trace_reduce_s,
                      "times": out.log, "readings": out.readings}),
          file=sys.stderr)
    for name, c in out.checks.items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
