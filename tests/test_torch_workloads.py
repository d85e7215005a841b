"""The port's trace workloads against the JAX package's, on the CPU: the
fixture CSVs and both loaders, the normalization passes, every synthetic
generator, ``characterize``, open-loop replay through every variant and
through the cloud simulator, and the bounded-memory fleet replay.

Exact equality throughout (canonical JSON of ``ScheduleMetrics.to_dict()``,
``TraceJob`` fields, generator arrays, stats), as in
``tests/test_torch_simulator.py``.  Also phase 10 of ``chip_smoke.py`` at
small size: its replay of the fixtures, audited, and its fleet replay.
"""
import dataclasses
import filecmp
import json
import math
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.cloud as jcloud  # noqa: E402
import repro.obs.trace as jtrace  # noqa: E402
import repro.workloads as jwl  # noqa: E402
import repro_torch.cloud as pcloud  # noqa: E402
import repro_torch.obs.trace as ptrace  # noqa: E402
import repro_torch.workloads as pwl  # noqa: E402
from repro.obs.audit import audit_records as jaudit_records  # noqa: E402
from repro_torch.obs.audit import audit_records as paudit_records  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

PACKAGES = {
    "jax": SimpleNamespace(cloud=jcloud, trace=jtrace, wl=jwl),
    "torch": SimpleNamespace(cloud=pcloud, trace=ptrace, wl=pwl),
}
FIXTURES = ("google_sample.csv", "azure_sample.csv")
SEEDS = (0, 17)


def _canon(m) -> dict:
    return json.loads(json.dumps(m.to_dict(), sort_keys=True))


def _both(fn, *args, **kw):
    return [fn(P, *args, **kw) for P in PACKAGES.values()]


def _jobs(trace):
    return [dataclasses.astuple(j) for j in trace.jobs]


def _arrays(trace):
    """A trace as per-field arrays (submit, duration, slots, priority) plus
    its name and job ids."""
    cols = list(zip(*_jobs(trace))) if trace.jobs else [()] * 6
    return (trace.name, list(cols[0]),
            *(np.asarray(c) for c in cols[1:5]), list(cols[5]))


def _same_arrays(a, b):
    assert a[0] == b[0] and a[1] == b[1] and a[-1] == b[-1]
    for x, y in zip(a[2:-1], b[2:-1]):
        assert x.dtype == y.dtype and np.array_equal(x, y)


# -- fixtures and loaders --------------------------------------------------------

@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_csvs_are_byte_equal_copies(name):
    port, ref = pwl.fixture_path(name), jwl.fixture_path(name)
    assert port != ref and os.path.dirname(port).startswith(
        os.path.join(REPO, "src", "repro_torch"))
    assert filecmp.cmp(port, ref, shallow=False)


def _load(P, loader, name):
    try:
        return ("ok", _jobs(P.wl.LOADERS[loader](P.wl.fixture_path(name))),
                P.wl.LOADERS[loader](P.wl.fixture_path(name)).name)
    except Exception as e:                       # a loader may refuse the other CSV
        return ("error", type(e).__name__, str(e))


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("loader", ["google", "azure"])
def test_loaders_match_jax_field_by_field(loader, name):
    j, p = _both(_load, loader, name)
    assert p == j
    if name.startswith(loader):
        assert p[0] == "ok" and len(p[1]) >= 30


def _normalized(P, name, seed):
    kind = name.split("_")[0]
    raw = P.wl.LOADERS[kind](P.wl.fixture_path(name))
    return [_jobs(raw.rebase_time()), _jobs(raw.sorted()),
            _jobs(raw.clamp_durations(60.0, 1800.0)),
            _jobs(raw.rescale_slots(48, max_fraction=0.25)),
            _jobs(raw.bucket_priorities(high_fraction=0.2 + 0.1 * seed)),
            _jobs(raw.truncate(10)), _jobs(raw.normalized(64)),
            _jobs(raw.normalized(32, max_fraction=0.2)),
            raw.horizon, raw.slot_seconds, raw.arrivals()]


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("seed", [0, 1])
def test_normalization_passes_match_jax(name, seed):
    j, p = _both(_normalized, name, seed)
    assert p == j


# -- generators and stats --------------------------------------------------------

GEN_SIZES = {"fleet": dict(n_jobs=300, days=0.5, nodes=20)}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", sorted(jwl.GENERATORS))
def test_generators_match_jax_as_arrays(kind, seed):
    kw = GEN_SIZES.get(kind, dict(n_jobs=40))
    j, p = (_arrays(P.wl.generate(kind, seed=seed, **kw)) for P in PACKAGES.values())
    _same_arrays(p, j)
    assert len(p[1]) == kw["n_jobs"]


def test_generator_registry_matches_jax():
    assert sorted(pwl.GENERATORS) == sorted(jwl.GENERATORS)
    assert pwl.__all__ == jwl.__all__
    assert all(hasattr(pwl, n) for n in pwl.__all__)


def _stats(P, source, seed):
    if source in FIXTURES:
        trace = P.wl.LOADERS[source.split("_")[0]](P.wl.fixture_path(source))
    else:
        trace = P.wl.generate(source, n_jobs=40, seed=seed)
    st = P.wl.characterize(trace)
    st2 = P.wl.characterize(trace, window=300.0, tail_k=5)
    tail = P.wl.hill_tail_index([j.slot_seconds for j in trace.jobs])
    return dataclasses.asdict(st), st.kv(), st.describe(), dataclasses.asdict(st2), tail


@pytest.mark.parametrize("source", FIXTURES + ("uniform", "bursty", "heavy_tail"))
def test_characterize_matches_jax(source):
    j, p = _both(_stats, source, 3)
    assert json.dumps(p, default=str) == json.dumps(j, default=str)
    assert p[0]["n_jobs"] >= 30


# -- replay ------------------------------------------------------------------------

def _fixture_trace(P, name, slots=64):
    return P.wl.LOADERS[name.split("_")[0]](P.wl.fixture_path(name)).normalized(slots)


def _replay(P, name, variant):
    trace = _fixture_trace(P, name)
    cfg = P.wl.ReplayConfig(cluster_slots=64)
    spec_rows = [(s.job_id, s.priority, s.min_replicas, s.max_replicas, s.submit_time,
                  w.total_work, w.data_bytes, w.scaling.time_per_step(3))
                 for s, w in P.wl.compile_trace(trace, cfg)]
    return _canon(P.wl.replay_variant(trace, variant, cfg)), spec_rows


@pytest.mark.parametrize("variant", jwl.REPLAY_VARIANTS)
@pytest.mark.parametrize("name", FIXTURES)
def test_replay_variant_matches_jax(name, variant):
    assert pwl.REPLAY_VARIANTS == jwl.REPLAY_VARIANTS
    j, p = _both(_replay, name, variant)
    assert p == j
    assert p[0]["dropped_jobs"] == 0 and p[0]["counters"]["completions"] == len(p[1])


def _replay_cloud(P, name, spot):
    c = P.cloud
    trace = _fixture_trace(P, name)
    pools = [c.NodePool("od", slots_per_node=8, price_per_slot_hour=0.048,
                        boot_latency=120.0, teardown_delay=30.0, max_nodes=8,
                        initial_nodes=1)]
    if spot:
        pools.append(c.NodePool("spot", slots_per_node=8, price_per_slot_hour=0.016,
                                market=c.SPOT, boot_latency=90.0, max_nodes=4,
                                spot_lifetime_mean=1800.0))
    prov = c.CloudProvider(pools, seed=23)
    asc = c.NodeAutoscaler(prov, c.AutoscalerConfig(
        tick_interval=30.0, scale_up_cooldown=30.0, scale_down_cooldown=120.0,
        idle_timeout=180.0, headroom_slots=8, spot_fraction=0.3 if spot else 0.0))
    sim = P.wl.replay_cloud(trace, P.wl.ReplayConfig(cluster_slots=64), prov,
                            variant="elastic", autoscaler=asc)
    return _canon(sim.metrics), dataclasses.asdict(sim.cost_report)


@pytest.mark.parametrize("spot", [False, True])
@pytest.mark.parametrize("name", FIXTURES)
def test_replay_cloud_with_autoscaler_matches_jax(name, spot):
    j, p = _both(_replay_cloud, name, spot)
    assert p == j
    assert p[0]["dropped_jobs"] == 0 and p[0]["total_cost"] > 0


def _fleet(P, n_jobs, nodes):
    trace = P.wl.google_fleet_trace(n_jobs=n_jobs, seed=3, days=3.0, nodes=nodes,
                                    slots_per_node=8).bucket_priorities()
    m = P.wl.replay_variant(trace, "elastic",
                            P.wl.ReplayConfig(cluster_slots=nodes * 8, rescale_gap=1800.0),
                            slots_per_node=8, util_series=False, track_phases=False)
    return _canon(m)


def test_reduced_fleet_replay_in_bounded_memory_matches_jax():
    """bench_simcore's fleet smoke row cut to 2,000 jobs on 125 nodes (the
    same offered load), elastic, in bounded-memory mode."""
    j, p = _both(_fleet, 2000, 125)
    assert p == j
    assert p["counters"]["completions"] == 2000 and p["dropped_jobs"] == 0
    assert not p["phase_seconds"] and p["counters"]["rescales"] > 0


def test_chip_smoke_fleet_replay_equals_jax_and_bench_row_fields():
    row, wall = chip_smoke.fleet_replay(n_jobs=2000, seed=3, days=3.0, nodes=125,
                                        slots_per_node=8)
    j = _fleet(PACKAGES["jax"], 2000, 125)
    assert row["events"] == j["counters"]["events"]
    assert row["stale_events"] == j["counters"]["stale_events"]
    assert row["completions"] == j["counters"]["completions"] == 2000
    assert row["rescales"] == j["counters"]["rescales"]
    assert row["utilization"] == j["utilization"] and row["dropped_jobs"] == 0
    assert wall > 0 and math.isclose(row["offered_load"], 0.7, rel_tol=1e-3)
    with open(chip_smoke.BENCH_SIMCORE) as fh:
        smoke = next(r for r in json.load(fh)["fleet"] if r["name"] == "smoke")
    assert {k: smoke[k] for k in ("n_jobs", "nodes", "slots_per_node", "days")} == {
        k: chip_smoke.FLEET_SMOKE[k] for k in ("n_jobs", "nodes", "slots_per_node", "days")}
    assert set(chip_smoke.FLEET_EXACT) <= set(smoke)


# -- traced replay and chip_smoke's phase 10 helpers ----------------------------------

def _traced_fixture(P, name, path):
    trace = _fixture_trace(P, name)
    cfg = P.wl.ReplayConfig(cluster_slots=64)
    with P.trace.install(P.trace.Tracer(str(path))) as tr:
        for v in P.wl.REPLAY_VARIANTS:
            P.wl.replay_variant(trace, v, cfg)
    tr.close()
    return P.trace.Tracer.load(str(path))


@pytest.mark.parametrize("name", FIXTURES)
def test_traced_replays_match_jax_and_pass_both_auditors(tmp_path, name):
    j, p = (_traced_fixture(P, name, tmp_path / f"{k}.jsonl")
            for k, P in PACKAGES.items())
    assert p == j
    for reports in (paudit_records(p), jaudit_records(p)):
        assert len(reports) == len(jwl.REPLAY_VARIANTS)
        assert all(r.ok for r in reports), [r.summary() for r in reports if not r.ok]


@pytest.mark.parametrize("kind,name", chip_smoke.TRACE_FIXTURES)
def test_chip_smoke_replays_each_fixture_through_every_variant(tmp_path, kind, name):
    path = str(tmp_path / "replay.jsonl")
    trace, runs = chip_smoke.replay_fixture(kind, name, path)
    assert list(runs) == list(jwl.REPLAY_VARIANTS) + ["cloud_autoscaled"]
    for v in jwl.REPLAY_VARIANTS:
        assert _canon(runs[v]) == _replay(PACKAGES["jax"], name, v)[0]
    jax_cloud = _replay_cloud(PACKAGES["jax"], name, False)[0]
    assert _canon(runs["cloud_autoscaled"]) == jax_cloud
    reports = chip_smoke.audit_trace(f"replay_{kind}", ptrace.Tracer.load(path))
    assert len(reports) == len(runs)
    assert all(m.counters["completions"] == len(trace) for m in runs.values())


def test_chip_smoke_trace_phase_runs_clean(tmp_path, capsys):
    chip_smoke.trace_phase(str(tmp_path))
    out = capsys.readouterr().out
    assert out.count("violations=0") == 2 * (len(jwl.REPLAY_VARIANTS) + 1)
    assert "VIOLATED" not in out and "interarrival_cv=" in out
