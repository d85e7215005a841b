"""The port's flight recorder (``repro_torch.obs``) against the JAX package's,
on the CPU.

(a) Traced simulator runs (Table 1's five variants, one trace per package):
    the records are equal record for record; each package's auditor passes
    both traces, and both flag the same tampering; ``analyze``,
    ``reconcile``, ``render_chains``, ``render_last_run`` and ``scan_trace``
    give equal results; the two audit CLIs give the same exit codes.
(b) ``diff_snapshots`` and the watchdog CLI on ``BENCH_simcore.json``
    against a perturbed copy give equal reports and exit codes.
(c) ``tests/helpers/operator_scenario.py``'s two scenarios, traced through
    the port's live operator with real port trainers on the CPU, pass the
    port's own auditor, and ``chip_smoke.py``'s phase 8 reads them.
(d) ``chip_smoke.py``'s phase 8 helpers at a small size on the CPU (the
    golden Table 1 comparison runs on the card only).

The tolerance is exact equality throughout: both packages compute the same
framework-free arithmetic.
"""
import copy
import dataclasses
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core.simulator as jsim  # noqa: E402
import repro.obs.audit as jaudit  # noqa: E402
import repro.obs.critical_path as jcp  # noqa: E402
import repro.obs.spans as jspans  # noqa: E402
import repro.obs.timeline as jtl  # noqa: E402
import repro.obs.trace as jtrace  # noqa: E402
import repro.obs.watchdog as jwd  # noqa: E402
import repro_torch.core.simulator as psim  # noqa: E402
import repro_torch.obs.audit as paudit  # noqa: E402
import repro_torch.obs.critical_path as pcp  # noqa: E402
import repro_torch.obs.spans as pspans  # noqa: E402
import repro_torch.obs.timeline as ptl  # noqa: E402
import repro_torch.obs.trace as ptrace  # noqa: E402
import repro_torch.obs.watchdog as pwd  # noqa: E402
from repro_torch.checkpoint import DiskCheckpointStore  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import (ElasticClusterController, ElasticTrainer,  # noqa: E402
                              JobSpec, JobStatus, PolicyConfig, TrainJobConfig,
                              local_slots)
from repro_torch.obs.profile import SimProfiler, install_profiler  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

PACKAGES = {
    "jax": dict(sim=jsim, audit=jaudit, cp=jcp, spans=jspans, tl=jtl,
                trace=jtrace, wd=jwd),
    "torch": dict(sim=psim, audit=paudit, cp=pcp, spans=pspans, tl=ptl,
                  trace=ptrace, wd=pwd),
}
TABLE1_VARIANTS = jsim.VARIANTS + ("elastic_preempt",)


def _traced_grid(pkg, path):
    """Table 1's cell (64 slots, 16 jobs, seed 7, gap 90 s, T_rescale_gap
    180 s) for the five variants, into one JSONL trace."""
    P = PACKAGES[pkg]
    specs = P["sim"].make_jacobi_jobs(seed=7, n_jobs=16, submission_gap=90.0)
    with P["trace"].install(P["trace"].Tracer(str(path))) as tr:
        for v in TABLE1_VARIANTS:
            P["sim"].run_variant(v, specs, total_slots=64, rescale_gap=180.0)
    tr.close()
    return P["trace"].Tracer.load(str(path))


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    d = tmp_path_factory.mktemp("traces")
    return {pkg: (d / f"{pkg}.jsonl",
                  _traced_grid(pkg, d / f"{pkg}.jsonl")) for pkg in PACKAGES}


def _runs(traces, pkg):
    return PACKAGES[pkg]["audit"].split_runs(traces[pkg][1])


def test_traced_records_match_jax_record_for_record(traces):
    j, p = traces["jax"][1], traces["torch"][1]
    assert len(p) == len(j) and p == j
    kinds = {r["kind"] for r in p}
    assert {"run_start", "job_submit", "job_start", "job_rescale",
            "job_preempt", "job_complete", "decision", "run_end"} <= kinds
    assert len(_runs(traces, "torch")) == len(TABLE1_VARIANTS)


@pytest.mark.parametrize("auditor", sorted(PACKAGES))
@pytest.mark.parametrize("trace", sorted(PACKAGES))
def test_each_auditor_passes_each_trace(traces, auditor, trace):
    reports = PACKAGES[auditor]["audit"].audit_records(traces[trace][1],
                                                       source=trace)
    assert len(reports) == len(TABLE1_VARIANTS)
    assert all(r.ok for r in reports), "\n".join(r.summary() for r in reports)
    assert all(all(r.checks.values()) for r in reports)


def _first(records, kind):
    return next(r for r in records if r["kind"] == kind)


def _double_book(recs):
    _first(recs, "job_start")["slots"] += 1000


def _unresume(recs):
    victim = _first(recs, "job_preempt")["job"]
    recs[:] = [r for r in recs if not (r["kind"] == "job_start"
                                       and r.get("resume") and r["job"] == victim)]


def _drop_complete(recs):
    recs.remove(_first(recs, "job_complete"))


def _truncate(recs):
    del recs[-1]


@pytest.mark.parametrize("tamper", [_double_book, _unresume, _drop_complete,
                                    _truncate])
def test_both_auditors_flag_the_same_tampering(traces, tamper):
    run = _runs(traces, "torch")[-1]         # elastic_preempt: has a preempt
    recs = copy.deepcopy(run)
    tamper(recs)
    j, p = (PACKAGES[pkg]["audit"].audit_records(recs) for pkg in PACKAGES)
    assert [r.summary() for r in p] == [r.summary() for r in j]
    assert not all(r.ok for r in p)


def test_audit_summaries_match_jax(traces):
    for pkg in PACKAGES:
        path = str(traces[pkg][0])
        j, p = jaudit.audit_file(path), paudit.audit_file(path)
        assert [dataclasses.asdict(r) for r in p] == \
            [dataclasses.asdict(r) for r in j]


@pytest.mark.parametrize("variant", TABLE1_VARIANTS)
def test_offline_analyses_match_jax(traces, variant):
    i = TABLE1_VARIANTS.index(variant)
    run = _runs(traces, "torch")[i]
    out = {}
    for pkg, P in PACKAGES.items():
        fleet = P["cp"].analyze(run)
        graph = P["spans"].build_span_graph(run)
        out[pkg] = dict(
            fleet=dataclasses.asdict(fleet), shares=fleet.shares(),
            reconcile=P["cp"].reconcile(run),
            per_job=P["cp"].decompose(run),
            chains=P["spans"].render_chains(graph),
            longest=graph.longest_causal_chain(),
            gantt=P["tl"].render(run, width=60),
            spikes=P["wd"].scan_trace(run),
            spikes_tight=P["wd"].scan_trace(
                run, P["wd"].WatchdogConfig(spike_window=3, spike_factor=1.2)))
    assert out["torch"] == out["jax"]
    assert out["torch"]["reconcile"] == []
    assert out["torch"]["fleet"]["jobs"] == 16


def test_render_last_run_matches_jax(traces):
    j = jtl.render_last_run(traces["jax"][1])
    p = ptl.render_last_run(traces["torch"][1])
    assert p == j and "capacity" in p
    assert ptl.render_last_run([]) == jtl.render_last_run([])


def test_live_span_tap_matches_the_offline_graph(traces):
    """A ``SpanTap`` around the port's simulator builds the same chains as
    the offline graph of the JAX package's trace of the same run."""
    specs = psim.make_jacobi_jobs(seed=7, n_jobs=16, submission_gap=90.0)
    _, pcfg, policy = psim.variant_setup("elastic_preempt", specs)
    tap = pspans.SpanTap(delegate=ptrace.Tracer())
    sim = psim.Simulator(64, pcfg, tracer=tap)
    sim.policy = policy
    for s in specs:
        sim.submit(s, psim.jacobi_workload(s.workload))
    sim.run()
    offline = jspans.build_span_graph(_runs(traces, "jax")[-1])
    assert pspans.render_chains(tap.graph()) == jspans.render_chains(offline)
    assert tap.graph().longest_causal_chain() == offline.longest_causal_chain()
    # the same records, but for the run id: this tracer saw one run, not five
    renumber = [dict(r, run=1) if "run" in r else r
                for r in _runs(traces, "jax")[-1]]
    assert tap.delegate.records == renumber


def test_audit_clis_give_the_same_exit_codes(traces, tmp_path, capsys):
    good = str(traces["torch"][0])
    bad = tmp_path / "bad.jsonl"
    recs = copy.deepcopy(traces["torch"][1])
    _double_book(recs)
    bad.write_text("".join(json.dumps(r) + "\n" for r in recs))
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    for args in ([good], [str(bad)], [good, str(bad)], [str(empty)]):
        j = jaudit.main(args)
        jout = capsys.readouterr().out
        p = paudit.main(args)
        pout = capsys.readouterr().out
        assert (p, pout) == (j, jout)
    assert paudit.main([good]) == 0 and paudit.main([str(bad)]) == 1
    capsys.readouterr()


def test_audit_cli_runs_as_a_module(traces):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.obs.audit",
                           str(traces["jax"][0])], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "obs-audit: PASS" in proc.stdout


def _perturbed(tmp_path):
    """``BENCH_simcore.json`` with every rung 20% slower and a null-tracer
    overhead past its 3% bar."""
    with open(os.path.join(REPO, "BENCH_simcore.json")) as fh:
        base = json.load(fh)
    fresh = copy.deepcopy(base)
    for row in fresh["throughput"]:
        row["events_per_sec"] *= 0.8
        row["events_retired_per_sec"] *= 0.8
    fresh["tracing"]["composed_null_overhead_pct"] = 3.5
    path = tmp_path / "BENCH_simcore.perturbed.json"
    path.write_text(json.dumps(fresh))
    return base, fresh, str(path)


def test_diff_snapshots_matches_jax(tmp_path):
    base, fresh, _ = _perturbed(tmp_path)
    for kw in ({}, dict(blocking_only=True)):
        for a, b in ((base, base), (fresh, base), (base, fresh)):
            j = jwd.diff_snapshots(a, b, **kw)
            p = pwd.diff_snapshots(a, b, **kw)
            assert p.to_dict() == j.to_dict()
            assert p.summary() == j.summary()
    assert pwd.diff_snapshots(base, base).ok
    assert not pwd.diff_snapshots(fresh, base).ok


def test_rolling_median_spikes_matches_jax():
    vals = [1.0, 1.1, 0.9, 1.0, 5.0, 1.0, 1.2, 0.0, 9.0, 1.0, 1.0, 40.0]
    for window in (1, 3, 5):
        for factor in (1.5, 3.0):
            assert pwd.rolling_median_spikes(vals, window=window, factor=factor) \
                == jwd.rolling_median_spikes(vals, window=window, factor=factor)


def test_watchdog_clis_give_the_same_exit_codes(tmp_path, capsys):
    _, _, perturbed = _perturbed(tmp_path)
    committed = os.path.join(REPO, "BENCH_simcore.json")
    cases = ([["--fresh", committed, "--baseline", committed]],
             [["--fresh", perturbed, "--baseline", committed]],
             [["--fresh", perturbed, "--blocking-only"]],
             [["--fresh", committed, "--baseline", perturbed,
               "--throughput-tol", "0.5"]])
    codes = []
    for (args,) in cases:
        outs = {}
        for pkg in PACKAGES:
            out = tmp_path / f"{pkg}.json"
            code = PACKAGES[pkg]["wd"].main(args + ["--out", str(out)])
            outs[pkg] = (code, capsys.readouterr().out, out.read_text())
        assert outs["torch"] == outs["jax"]
        codes.append(outs["torch"][0])
    assert codes == [0, 1, 1, 0]


def test_install_profiler_scopes_and_the_simulator_adopts_it():
    specs = psim.make_jacobi_jobs(seed=7, n_jobs=8, submission_gap=90.0)
    prof = SimProfiler()
    with install_profiler(prof):
        m = psim.run_variant("elastic", specs, total_slots=64)
    assert psim.Simulator(8, PolicyConfig()).profiler is None
    rep = prof.report()
    assert rep["events_total"] == m.counters["events"] > 0
    assert set(rep["events"]) == {"submit", "complete"}
    assert rep["sections"]["heap_push"]["count"] > 0


# ---------------------------------------------------------------------------
# (c) the live operator's smoke scenarios, traced, through the port's auditor
# ---------------------------------------------------------------------------

def _factory(steps, seed):
    job = TrainJobConfig(global_batch=8, seq_len=16, total_steps=steps,
                         seed=seed)
    return lambda slots: ElasticTrainer(smoke_config("yi-6b"), job, slots,
                                        device="cpu")


def _priority_shrink_expand(tracer, tmp_path):
    op = ElasticClusterController(local_slots(8), slots=8,
                                  policy=PolicyConfig(rescale_gap=0.0),
                                  steps_per_tick=2, tracer=tracer)
    op.submit(JobSpec("low", 1, 2, 8, 0.0, divides=8), _factory(20, 0))
    op.submit(JobSpec("high", 5, 4, 8, 0.001, divides=8), _factory(8, 1))
    op.run()
    moves = [(a, b) for _, j, a, b, _ in op.rescale_events if j == "low"]
    assert moves[0][0] > moves[0][1] and moves[-1][0] < moves[-1][1]
    assert op.live["low"].trainer.step_idx == 20
    assert op.live["high"].trainer.step_idx == 8
    return op


def _restart_from_disk(tracer, tmp_path):
    store = DiskCheckpointStore(str(tmp_path / "ckpt"))
    op = ElasticClusterController(local_slots(8), slots=8,
                                  policy=PolicyConfig(rescale_gap=0.0),
                                  disk_store=store, steps_per_tick=2,
                                  tracer=tracer)
    op.submit(JobSpec("victim", 3, 2, 4, 0.0, divides=8), _factory(20, 5),
              checkpoint_every=4)
    op._process_submissions()
    live = op.live["victim"]
    for _ in range(6):
        live.trainer.step()
    live.trainer.save_disk(store, "victim")
    op.inject_failure("victim")
    assert live.trainer is None
    op.run()
    assert op.live["victim"].failures == 1
    assert op.live["victim"].trainer.step_idx == 20
    return op


@pytest.mark.parametrize("scenario", [_priority_shrink_expand,
                                      _restart_from_disk])
def test_operator_scenarios_pass_the_ports_auditor(scenario, tmp_path):
    tracer = ptrace.Tracer(str(tmp_path / "operator.jsonl"), keep=True)
    op = scenario(tracer, tmp_path)
    tracer.close()
    assert all(j.status == JobStatus.COMPLETED
               for j in op.cluster.jobs.values())
    reports = paudit.audit_file(str(tmp_path / "operator.jsonl"))
    assert len(reports) == 1 and reports[0].ok, reports[0].summary()
    assert paudit.audit_records(tracer.records)[0].ok
    assert pcp.reconcile(tracer.records) == []
    assert "capacity" in ptl.render_last_run(tracer.records)
    chip_smoke.audit_operator_trace("A", str(tmp_path / "operator.jsonl"))


# ---------------------------------------------------------------------------
# (d) chip_smoke.py's phase 8 helpers
# ---------------------------------------------------------------------------

def test_chip_smoke_audit_fails_on_a_violation(traces):
    records = copy.deepcopy(_runs(traces, "torch")[-1])
    assert len(chip_smoke.audit_trace("ok", records)) == 1
    _double_book(records)
    with pytest.raises(RuntimeError, match="slot"):
        chip_smoke.audit_trace("tampered", records)


def test_chip_smoke_golden_diff():
    want = {"a": 454.52149917720845, "n": 3, "c": {"x": 0.0, "k": "s"}}
    assert chip_smoke.golden_diff(copy.deepcopy(want), want) == ([], 0.0)
    ulp = dict(want, a=454.5214991772085)
    bad, err = chip_smoke.golden_diff(ulp, want)
    assert bad == [] and 0.0 < err < 1e-15
    for got in (dict(want, a=want["a"] * (1 + 1e-8)), dict(want, n=4),
                dict(want, n=3.0), dict(want, c={"x": 0.0}),
                dict(want, c={"x": 1e-300, "k": "s"})):
        assert chip_smoke.golden_diff(got, want)[0], got


def test_chip_smoke_figure_sweeps_and_event_rate(capsys):
    assert chip_smoke.figure_sweeps(seeds=(0,), gaps=(0, 90), tgaps=(0,)) == 11
    rep = chip_smoke.event_rate("cpu", job_counts=(16, 32), repeats=2)
    out = capsys.readouterr().out
    assert out.count("[simulator] cell=fig7.") == 8
    assert out.count("[simulator] cell=fig8.") == 3
    assert out.count("events_retired_per_s=") == 2
    assert set(rep["events"]) == {"submit", "complete"}
    assert rep["events_total"] == 2 * 64 and rep["wall_s"] > 0
