"""The port's policy simulator (paper C3) against the JAX package's, on the CPU.

Both packages run the same framework-free float arithmetic in the same
order, so the tolerance is exact equality: of the canonical JSON form of
``ScheduleMetrics.to_dict()`` (``json.loads(json.dumps(..., sort_keys=True))``,
which turns tuples into lists and leaves every float as it is), of the pop
order of the event queues, and of the perf models' floats.  The port is
compared with the JAX package, never with the golden fixture.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core.autoscale as jauto  # noqa: E402
import repro.core.events as jev  # noqa: E402
import repro.core.perf_model as jpm  # noqa: E402
import repro.core.simulator as jsim  # noqa: E402
import repro_torch.core.autoscale as pauto  # noqa: E402
import repro_torch.core.events as pev  # noqa: E402
import repro_torch.core.perf_model as ppm  # noqa: E402
import repro_torch.core.simulator as psim  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import count_params  # noqa: E402
from repro.core.metrics import compute_metrics as jcompute  # noqa: E402
from repro.core.policies import PolicyConfig as JPolicyConfig  # noqa: E402
from repro.obs.profile import SimProfiler as JProfiler  # noqa: E402
from repro_torch.configs import get_config as pget_config  # noqa: E402
from repro_torch.core.metrics import compute_metrics as pcompute  # noqa: E402
from repro_torch.core.policies import PolicyConfig as PPolicyConfig  # noqa: E402
from repro_torch.models.params import param_count  # noqa: E402
from repro_torch.obs.profile import SimProfiler as PProfiler  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

PACKAGES = {
    "jax": dict(sim=jsim, auto=jauto, policy=JPolicyConfig, compute=jcompute,
                profiler=JProfiler),
    "torch": dict(sim=psim, auto=pauto, policy=PPolicyConfig, compute=pcompute,
                  profiler=PProfiler),
}
# the paper's Table 1 cell (64 slots, 16 Jacobi jobs, seed 7, gap 90 s,
# T_rescale_gap 180 s) and the preempting extension
TABLE1_VARIANTS = jsim.VARIANTS + ("elastic_preempt",)
SEEDS = (0, 5)
FIG7_GAPS = (0.0, 120.0, 300.0)
FIG8_TGAPS = (0.0, 300.0, 1200.0)


def _canon(m) -> dict:
    return json.loads(json.dumps(m.to_dict(), sort_keys=True))


def _variant(pkg, variant, seed=7, gap=90.0, tgap=180.0, n_jobs=16):
    sim = PACKAGES[pkg]["sim"]
    specs = sim.make_jacobi_jobs(seed=seed, n_jobs=n_jobs, submission_gap=gap)
    return _canon(sim.run_variant(variant, specs, total_slots=64,
                                  rescale_gap=tgap))


def _both(*args, **kw):
    return [_variant(pkg, *args, **kw) for pkg in PACKAGES]


@pytest.mark.parametrize("variant", TABLE1_VARIANTS)
def test_table1_variant_matches_jax_exactly(variant):
    j, p = _both(variant)
    assert p == j
    assert p["dropped_jobs"] == 0 and p["counters"]["completions"] == 16
    assert p["phase_seconds"], "the phase rollup is missing"


@pytest.mark.parametrize("variant", jsim.VARIANTS)
@pytest.mark.parametrize("gap", FIG7_GAPS)
@pytest.mark.parametrize("seed", SEEDS)
def test_fig7_submission_gap_matches_jax_exactly(seed, gap, variant):
    j, p = _both(variant, seed=seed, gap=gap)
    assert p == j


@pytest.mark.parametrize("variant", jsim.VARIANTS)
@pytest.mark.parametrize("tgap", FIG8_TGAPS)
@pytest.mark.parametrize("seed", SEEDS)
def test_fig8_rescale_gap_matches_jax_exactly(seed, tgap, variant):
    j, p = _both(variant, seed=seed, gap=180.0, tgap=tgap)
    assert p == j


def _policy_run(pkg, name):
    """Table 1's jobs under one of the autoscale policies, set on the
    simulator after construction as the reference's tests do."""
    P = PACKAGES[pkg]
    sim_mod, auto = P["sim"], P["auto"]
    specs = sim_mod.make_jacobi_jobs(seed=7, n_jobs=16, submission_gap=60.0)
    pcfg = P["policy"](rescale_gap=120.0)
    sim = sim_mod.Simulator(48, pcfg)
    if name == "aging":
        sim.policy = auto.AgingPolicy(pcfg, age_rate=1.0 / 120.0,
                                      max_boost=3.0)
    elif name == "cost_benefit":
        sim.policy = auto.CostBenefitPolicy(
            pcfg, lambda j: sim.workloads[j.job_id], benefit_margin=2.0,
            protect_tail=0.1)
    else:
        sim.policy = auto.PreemptingPolicy(pcfg)
    for s in specs:
        sim.submit(s, sim_mod.jacobi_workload(s.workload))
    return _canon(sim.run())


@pytest.mark.parametrize("name", ["aging", "cost_benefit", "preempting"])
def test_autoscale_policies_match_jax_exactly(name):
    j, p = (_policy_run(pkg, name) for pkg in PACKAGES)
    assert p == j
    assert p["dropped_jobs"] == 0


def _bounded_run(pkg):
    """bench_simcore's 128-job throughput rung in bounded-memory mode, with
    the self-profiler on."""
    P = PACKAGES[pkg]
    specs = P["sim"].make_jacobi_jobs(seed=11, n_jobs=128, submission_gap=45.0)
    prof = P["profiler"]()
    sim = P["sim"].Simulator(64, P["policy"](rescale_gap=180.0),
                             util_series=False, track_phases=False,
                             profiler=prof)
    for s in specs:
        sim.submit(s, P["sim"].jacobi_workload(s.workload))
    m = _canon(sim.run())
    counts = {k: v["count"] for k, v in prof.report()["events"].items()}
    return m, counts, len(sim.util.events)


def test_bounded_memory_mode_matches_jax_exactly():
    (jm, jc, jn), (pm, pc, pn) = (_bounded_run(pkg) for pkg in PACKAGES)
    assert pm == jm
    assert pc == jc and sum(pc.values()) == pm["counters"]["events"]
    assert pn == jn == 0, "bounded-memory mode kept a utilization series"
    assert pm["counters"]["completions"] == 128 and not pm["phase_seconds"]


def test_compute_metrics_phase_rollup_matches_jax_exactly():
    """Each package's ``compute_metrics(phases=...)`` over its own finished
    simulation; with and without the ledger."""
    out = {}
    for pkg, P in PACKAGES.items():
        specs = P["sim"].make_jacobi_jobs(seed=3, n_jobs=12,
                                          submission_gap=30.0)
        _, pcfg, policy = P["sim"].variant_setup("elastic_preempt", specs,
                                                 rescale_gap=60.0)
        sim = P["sim"].Simulator(32, pcfg)
        sim.policy = policy
        for s in specs:
            sim.submit(s, P["sim"].jacobi_workload(s.workload))
        sim.run()
        jobs = list(sim.cluster.jobs.values())
        out[pkg] = [_canon(P["compute"](jobs, sim.util, phases=sim.phases)),
                    _canon(P["compute"](jobs, sim.util))]
    assert out["torch"] == out["jax"]
    with_phases, without = out["torch"]
    assert with_phases["phase_seconds"] and with_phases["dominant_phase"]
    assert not without["phase_seconds"]
    assert sum(with_phases["dominant_phase"].values()) == 12


def _queue_script(seed, n=400):
    """A seeded mix of push (same-time ties, submit-style tiebreaks),
    cancel of a queued event, pop and pop_batch."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.55:
            tb = None if rng.random() < 0.5 else (
                -int(rng.integers(1, 6)), f"j{int(rng.integers(100)):03d}")
            ops.append(("push", float(rng.integers(0, 40)), tb))
        elif r < 0.7:
            ops.append(("cancel", int(rng.integers(1 << 30))))
        elif r < 0.85:
            ops.append(("pop",))
        else:
            ops.append(("pop_batch",))
    return ops


def _replay_queue(mod, ops):
    q = mod.EventQueue()
    queued, out, batch = [], [], []

    def popped(evs):
        ids = {id(ev) for ev in evs}
        queued[:] = [ev for ev in queued if id(ev) not in ids]
        return [(ev.time, ev.kind, ev.payload) for ev in evs]
    for i, op in enumerate(ops):
        if op[0] == "push":
            kw = {} if op[2] is None else dict(tiebreak=op[2])
            queued.append(q.push(op[1], f"k{i % 5}", i, **kw))
        elif op[0] == "cancel" and queued:
            q.cancel(queued.pop(op[1] % len(queued)))
        elif op[0] == "pop":
            ev = q.pop()
            out.append(None if ev is None else popped([ev]))
        elif op[0] == "pop_batch":
            q.pop_batch(batch)
            out.append(popped(batch))
        out.append((len(q), q.peek_time(), q.stale_dropped))
    while True:
        ev = q.pop()
        if ev is None:
            break
        out.append(popped([ev]))
    return out, q.stale_total


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_event_queue_pop_order_matches_jax(seed):
    ops = _queue_script(seed)
    j, p = _replay_queue(jev, ops), _replay_queue(pev, ops)
    assert p == j
    assert p[1] > 0, "the script cancelled nothing"


REPLICAS = (1, 2, 3, 4, 8, 16, 32, 64, 128)
DATA_BYTES = (0.0, 2.1e6, 5.4e8, 2.1e9)


@pytest.mark.parametrize("size", sorted(jpm.JACOBI_SIZES))
def test_jacobi_model_matches_jax_exactly(size):
    assert ppm.JACOBI_SIZES == jpm.JACOBI_SIZES
    d = jpm.JACOBI_SIZES[size]
    jm = jpm.JacobiModel(d["grid_n"], d["timesteps"])
    pm = ppm.JacobiModel(d["grid_n"], d["timesteps"])
    assert [pm.time_per_step(r) for r in REPLICAS] == \
        [jm.time_per_step(r) for r in REPLICAS]
    assert pm.data_bytes == jm.data_bytes
    js, ps = jm.scaling_model(REPLICAS[1:]), pm.scaling_model(REPLICAS[1:])
    assert ps.points == js.points
    xs = (0, 1, 3, 5, 20, 100, 500)
    assert [ps.time_per_unit(x) for x in xs] == [js.time_per_unit(x) for x in xs]
    assert [ppm.interp_piecewise(ps.points, x + 0.5) for x in xs] == \
        [jpm.interp_piecewise(js.points, x + 0.5) for x in xs]


@pytest.mark.parametrize("fast_lane", [True, False])
def test_rescale_model_matches_jax_exactly(fast_lane):
    jm, pm = jpm.RescaleModel(fast_lane), ppm.RescaleModel(fast_lane)
    for old in REPLICAS:
        for new in REPLICAS:
            for b in DATA_BYTES:
                assert pm.stages(old, new, b) == jm.stages(old, new, b)
                assert pm.total(old, new, b) == jm.total(old, new, b)
        for b in DATA_BYTES:
            assert pm.preempt_cost(old, b) == jm.preempt_cost(old, b)
            assert pm.resume_cost(old, b) == jm.resume_cost(old, b)


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-1.3b"])
def test_param_count_matches_jax_count_params(arch):
    assert param_count(pget_config(arch)) == count_params(jget_config(arch))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "yi-6b", "mamba2-1.3b"])
def test_arch_model_counts_flops_from_active_params_as_the_reference(arch):
    """FLOPs from the active parameters (granite-moe: 881,690,112 of
    3,299,182,080), bytes from all of them, as the JAX package's
    ``arch_model_from_config``; only the card's constants differ."""
    ours = ppm.arch_model_from_config(pget_config(arch), seq_len=2048, global_batch=8)
    ref = jpm.arch_model_from_config(jget_config(arch), seq_len=2048, global_batch=8)
    assert ours.flops_per_step == ref.flops_per_step
    assert ours.param_bytes == ref.param_bytes and ours.data_bytes == ref.data_bytes
    if arch == "granite-moe-3b-a800m":
        assert ours.flops_per_step == 6.0 * 881_690_112 * 2048 * 8
        assert ours.param_bytes == 2.0 * 3_299_182_080


def test_h100_arch_model_decreases_with_groups_and_is_sublinear():
    """The reference's monotonicity test on the H100 model: step time falls
    with replica groups, and the NVLink all-reduce keeps the speedup
    sublinear."""
    m = ppm.arch_model_from_config(pget_config("yi-6b"))
    ts = [m.time_per_step(g) for g in (1, 2, 4, 8, 16)]
    assert all(a > b for a, b in zip(ts, ts[1:]))
    assert ts[0] / ts[-1] < 16.0
    assert m.peak_flops == ppm.H100_PEAK_FLOPS_BF16 == 989e12
    assert m.gpus_per_group == ppm.GPUS_PER_REPLICA == 8
    assert m.data_bytes == 5 * m.param_bytes


def test_perf_model_states_no_tpu_constant():
    with open(ppm.__file__) as fh:
        src = fh.read()
    for word in ("V5E", "v5e", "ICI", "TPU", "CHIPS_PER_REPLICA"):
        assert word not in src, word
    assert chip_smoke.PEAK_FLOPS[chip_smoke.torch.float32] == \
        ppm.H100_PEAK_FLOPS_FP32
    assert chip_smoke.PEAK_FLOPS[chip_smoke.torch.bfloat16] == \
        ppm.H100_PEAK_FLOPS_BF16
    assert chip_smoke.PEAK_BYTES == ppm.H100_HBM_BW


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-1.3b"])
def test_chip_smoke_arch_prediction_is_one_card_fp32(arch):
    """Phase 8's prediction: 6*N*tokens at global batch 8 x 2048 over one
    card's fp32 peak at mfu 0.4."""
    cfg = pget_config(arch)
    if arch == "yi-6b":
        cfg = cfg.with_(num_layers=4)
    m = chip_smoke.arch_prediction(cfg)
    flops = 6.0 * param_count(cfg) * 8 * 2048
    assert m.flops_per_step == flops
    assert m.time_per_step(1) == flops / (67e12 * 0.4)
    assert dataclasses.replace(m, gpus_per_group=8).time_per_step(1) < \
        m.time_per_step(1)
