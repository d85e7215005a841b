"""Perf/anomaly watchdog: diff a fresh ``BENCH_simcore.json`` against the
committed baseline, and flag metric-stream anomalies.

Copy of ``repro.obs.watchdog`` (framework-free): it reads the JAX
package's ``BENCH_simcore.json`` schema unchanged.  It is the no-regression
gate of the simulator's event loop:

- **baseline diff** — every job-count rung's events/sec must be within
  ``throughput_rel_tol`` of ``benchmarks/baselines/BENCH_simcore.baseline.
  json`` (default 15%, so a 20% regression trips), peak RSS within
  ``rss_rel_tol``, ckpt save walls within ``ckpt_rel_tol``, and the
  machine-independent invariants must hold outright: composed null-tracer
  overhead < 3%, active-tracer overhead under its ceiling, delta
  checkpoints writing strictly fewer bytes than full snapshots, the async
  barrier publishing the last submitted step, schema keys present.
- **anomaly scan** — :func:`rolling_median_spikes` flags points that jump
  ``spike_factor``x above the rolling median of their trailing window;
  :func:`scan_trace` applies it to the per-completion response-time stream
  of a flight-recorder trace ("where did my p99 go?" starts here).

Two speeds: the full diff (absolute throughput/RSS are machine-dependent,
so a noisy machine should not block on it) and ``--blocking-only``, which
checks just the machine-independent invariants.

CLI::

    PYTHONPATH=src python -m repro_torch.obs.watchdog \
        --fresh BENCH_simcore.json \
        --baseline benchmarks/baselines/BENCH_simcore.baseline.json \
        [--blocking-only] [--out BENCH_watchdog_diff.json]
"""
from __future__ import annotations

import argparse
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence


@dataclass
class WatchdogConfig:
    #: per-rung events/sec may drop at most this fraction vs. baseline
    throughput_rel_tol: float = 0.15
    #: peak RSS may grow at most this fraction vs. baseline
    rss_rel_tol: float = 0.30
    #: fleet rows: events-retired/sec may drop at most this fraction vs. the
    #: baseline row of the same name (fleet rows run once, not best-of-N, so
    #: they carry more scheduler noise than the micro rungs)
    fleet_rel_tol: float = 0.25
    #: composed null-tracer overhead must stay under this (percent)
    null_overhead_pct_max: float = 3.0
    #: active-tracer overhead ceiling (percent); None disables the check —
    #: matches bench_simcore.ACTIVE_OVERHEAD_CEILING_PCT (recalibrated with
    #: the fleet-scale refactor: same absolute tracer cost over a ~2.3x
    #: faster untraced grid reads as ~40%, with file-write noise swinging
    #: it 37-65% run to run)
    active_overhead_pct_max: Optional[float] = 90.0
    #: ckpt save walls may grow at most this fraction vs. baseline (disk
    #: speed varies across runners far more than CPU throughput does)
    ckpt_rel_tol: float = 1.0
    #: anomaly scan: a point is a spike if > factor x rolling median
    spike_factor: float = 3.0
    spike_window: int = 9


@dataclass
class WatchdogReport:
    """Mirror of the auditor's report shape: named checks, each with
    violation strings; ``ok`` means no check drew blood."""
    checks: Dict[str, List[str]] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)

    def fail(self, check: str, msg: str) -> None:
        self.checks.setdefault(check, []).append(msg)

    def passed(self, check: str) -> None:
        self.checks.setdefault(check, [])

    @property
    def ok(self) -> bool:
        return not any(self.checks.values())

    @property
    def violations(self) -> List[str]:
        return [f"{name}: {msg}" for name, msgs in sorted(self.checks.items())
                for msg in msgs]

    def summary(self) -> str:
        lines = [f"watchdog: {'OK' if self.ok else 'REGRESSION'} "
                 f"({len(self.checks)} checks, "
                 f"{len(self.violations)} violations)"]
        for name in sorted(self.checks):
            msgs = self.checks[name]
            lines.append(f"  {'FAIL' if msgs else 'ok  '} {name}")
            lines.extend(f"       {m}" for m in msgs)
        lines.extend(f"  note {n}" for n in self.notes)
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, Any]:
        return {"ok": self.ok, "checks": self.checks, "notes": self.notes}


def diff_snapshots(fresh: Dict[str, Any], baseline: Dict[str, Any],
                   cfg: Optional[WatchdogConfig] = None, *,
                   blocking_only: bool = False) -> WatchdogReport:
    """Compare a fresh bench snapshot against the committed baseline.

    ``blocking_only`` skips the machine-dependent comparisons (absolute
    events/sec, RSS) and keeps the invariant checks that must hold on any
    machine.
    """
    cfg = cfg or WatchdogConfig()
    rep = WatchdogReport()

    # -- schema invariants (always) ------------------------------------------
    rep.passed("schema")
    for key in ("throughput", "tracing"):
        if key not in fresh:
            rep.fail("schema", f"fresh snapshot missing '{key}'")
    if fresh.get("schema", 0) >= 2:
        for key in ("profile", "peak_rss_bytes"):
            if key not in fresh:
                rep.fail("schema", f"schema>=2 snapshot missing '{key}'")
    if fresh.get("schema", 0) >= 3:
        if not fresh.get("fleet"):
            rep.fail("schema", "schema>=3 snapshot missing 'fleet' rows")
    if fresh.get("schema", 0) >= 4:
        if not fresh.get("ckpt"):
            rep.fail("schema", "schema>=4 snapshot missing 'ckpt' rows")

    # -- checkpoint fast-lane invariants (always; machine-independent) -------
    ckpt = fresh.get("ckpt")
    if ckpt:
        rep.passed("ckpt_invariants")
        if not ckpt.get("delta_bytes", 0) < ckpt.get("full_bytes", 0):
            rep.fail("ckpt_invariants",
                     f"delta checkpoint wrote {ckpt.get('delta_bytes')} bytes"
                     f" >= full snapshot {ckpt.get('full_bytes')}")
        if not ckpt.get("async_published_latest", False):
            rep.fail("ckpt_invariants",
                     "async barrier did not publish the last submitted step")

    # -- null-tracer overhead (always; machine-independent ratio) ------------
    rep.passed("null_overhead")
    tracing = fresh.get("tracing", {})
    null_pct = tracing.get("composed_null_overhead_pct")
    if null_pct is None:
        rep.fail("null_overhead", "composed_null_overhead_pct missing")
    elif null_pct >= cfg.null_overhead_pct_max:
        rep.fail("null_overhead",
                 f"composed null overhead {null_pct:.2f}% >= "
                 f"{cfg.null_overhead_pct_max:.1f}%")

    # -- active-tracer overhead ceiling (always) -----------------------------
    if cfg.active_overhead_pct_max is not None:
        rep.passed("active_overhead")
        active_pct = tracing.get("active_overhead_pct")
        if active_pct is None:
            rep.fail("active_overhead", "active_overhead_pct missing")
        elif active_pct >= cfg.active_overhead_pct_max:
            rep.fail("active_overhead",
                     f"active overhead {active_pct:.2f}% >= ceiling "
                     f"{cfg.active_overhead_pct_max:.1f}%")

    if blocking_only:
        rep.notes.append("blocking-only: throughput/RSS diffs skipped "
                         "(machine-dependent)")
        return rep

    # -- per-rung events/sec vs. baseline ------------------------------------
    rep.passed("throughput")
    base_rungs = {r["n_jobs"]: r for r in baseline.get("throughput", [])}
    fresh_rungs = {r["n_jobs"]: r for r in fresh.get("throughput", [])}
    for n_jobs, base in sorted(base_rungs.items()):
        cur = fresh_rungs.get(n_jobs)
        if cur is None:
            rep.fail("throughput", f"rung n_jobs={n_jobs} missing from "
                                   f"fresh snapshot")
            continue
        b, f = base.get("events_per_sec", 0.0), cur.get("events_per_sec", 0.0)
        if b > 0.0 and f < b * (1.0 - cfg.throughput_rel_tol):
            rep.fail("throughput",
                     f"n_jobs={n_jobs}: {f:.0f} events/s is "
                     f"{100.0 * (1.0 - f / b):.1f}% below baseline "
                     f"{b:.0f} (tol {100.0 * cfg.throughput_rel_tol:.0f}%)")

    # -- fleet replay rows vs. baseline (schema 3) ---------------------------
    # diff by row-name intersection: the smoke row is the everyday gate, the
    # month-long full row only exists in snapshots run with --fleet-full — a
    # missing full row is a note, never a failure
    base_fleet = {r["name"]: r for r in baseline.get("fleet", [])}
    fresh_fleet = {r["name"]: r for r in fresh.get("fleet", [])}
    if base_fleet:
        rep.passed("fleet")
        for name, base in sorted(base_fleet.items()):
            cur = fresh_fleet.get(name)
            if cur is None:
                rep.notes.append(f"fleet: row '{name}' not in fresh "
                                 f"snapshot (run with --fleet-full?); "
                                 f"diff skipped")
                continue
            b = base.get("events_retired_per_sec", 0.0)
            f = cur.get("events_retired_per_sec", 0.0)
            if b > 0.0 and f < b * (1.0 - cfg.fleet_rel_tol):
                rep.fail("fleet",
                         f"{name}: {f:.0f} retired events/s is "
                         f"{100.0 * (1.0 - f / b):.1f}% below baseline "
                         f"{b:.0f} (tol {100.0 * cfg.fleet_rel_tol:.0f}%)")

    # -- checkpoint save walls vs. baseline (schema 4) -----------------------
    base_ckpt = baseline.get("ckpt")
    if base_ckpt and ckpt:
        rep.passed("ckpt")
        for field_name in ("full_save_us", "delta_save_us"):
            b, f = base_ckpt.get(field_name, 0.0), ckpt.get(field_name, 0.0)
            if b > 0.0 and f > b * (1.0 + cfg.ckpt_rel_tol):
                rep.fail("ckpt",
                         f"{field_name}: {f:.0f}us is "
                         f"{100.0 * (f / b - 1.0):.1f}% above baseline "
                         f"{b:.0f}us (tol {100.0 * cfg.ckpt_rel_tol:.0f}%)")

    # -- peak RSS vs. baseline -----------------------------------------------
    rep.passed("peak_rss")
    b_rss = baseline.get("peak_rss_bytes")
    f_rss = fresh.get("peak_rss_bytes")
    if b_rss and f_rss:
        if f_rss > b_rss * (1.0 + cfg.rss_rel_tol):
            rep.fail("peak_rss",
                     f"peak RSS {f_rss / 1e6:.1f}MB is "
                     f"{100.0 * (f_rss / b_rss - 1.0):.1f}% above baseline "
                     f"{b_rss / 1e6:.1f}MB (tol "
                     f"{100.0 * cfg.rss_rel_tol:.0f}%)")
    elif b_rss and not f_rss:
        rep.fail("peak_rss", "peak_rss_bytes missing from fresh snapshot")
    else:
        rep.notes.append("peak_rss: no baseline value; diff skipped")
    return rep


# ---------------------------------------------------------------------------
# Metric-stream anomaly scan
# ---------------------------------------------------------------------------

def rolling_median_spikes(values: Sequence[float], *, window: int = 9,
                          factor: float = 3.0) -> List[int]:
    """Indices whose value exceeds ``factor`` x the median of the trailing
    ``window`` points.  Needs a full window of history, so the first
    ``window`` points are never flagged."""
    spikes = []
    for i in range(window, len(values)):
        trail = sorted(values[i - window:i])
        med = trail[window // 2]
        if med > 0.0 and values[i] > factor * med:
            spikes.append(i)
    return spikes


def scan_trace(records: Sequence[Dict[str, Any]],
               cfg: Optional[WatchdogConfig] = None) -> List[str]:
    """Flag response-time spikes in one run's trace: the per-completion
    stream (complete.t - submit.t, in completion order) is scanned against
    its own rolling median.  Returns human-readable anomaly strings."""
    cfg = cfg or WatchdogConfig()
    submits = {r["job"]: r["t"] for r in records
               if r.get("kind") == "job_submit"}
    stream = [(r["job"], r["t"] - submits[r["job"]]) for r in records
              if r.get("kind") == "job_complete" and r["job"] in submits]
    values = [v for _, v in stream]
    return [
        f"response-time spike: job {stream[i][0]} took {values[i]:.0f}s, "
        f">{cfg.spike_factor:.0f}x the rolling median"
        for i in rolling_median_spikes(values, window=cfg.spike_window,
                                       factor=cfg.spike_factor)]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Diff a fresh BENCH_simcore.json against the committed "
                    "baseline.")
    ap.add_argument("--fresh", default="BENCH_simcore.json")
    ap.add_argument("--baseline",
                    default="benchmarks/baselines/"
                            "BENCH_simcore.baseline.json")
    ap.add_argument("--out", default=None,
                    help="write the diff report as JSON here")
    ap.add_argument("--blocking-only", action="store_true",
                    help="machine-independent invariants only "
                         "(null/active overhead, schema)")
    ap.add_argument("--throughput-tol", type=float, default=None)
    args = ap.parse_args(argv)

    with open(args.fresh) as fh:
        fresh = json.load(fh)
    baseline: Dict[str, Any] = {}
    if not args.blocking_only:
        with open(args.baseline) as fh:
            baseline = json.load(fh)

    cfg = WatchdogConfig()
    if args.throughput_tol is not None:
        cfg.throughput_rel_tol = args.throughput_tol
    rep = diff_snapshots(fresh, baseline, cfg,
                         blocking_only=args.blocking_only)
    print(rep.summary())
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rep.to_dict(), fh, indent=2)
            fh.write("\n")
    return 0 if rep.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
