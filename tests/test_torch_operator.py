"""The port's live operator against the JAX package's, on the CPU.

(a) Stub trainers through both packages' ``ElasticClusterController`` with a
    deterministic ``step_time_fn``: the rescale events, replica trace,
    ``ScheduleMetrics`` and trace records must be exactly equal.
(b) ``chip_smoke.py``'s phase 7 scenario functions at smoke size with real
    port trainers on the CPU: the low job of scenario A ends within 5e-5 of a
    single-device JAX ``ElasticTrainer`` (``tests/helpers/elastic_trajectory.py``
    holds the reference to the same tolerance).
(c) The port operator's trace records pass ``repro.obs.audit``.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core.elastic as jel  # noqa: E402
import repro.core.operator as jop  # noqa: E402
import repro.obs.trace as jtrace  # noqa: E402
import repro_torch.core.elastic as pel  # noqa: E402
import repro_torch.core.operator as pop  # noqa: E402
import repro_torch.obs.trace as ptrace  # noqa: E402
from repro.checkpoint import DiskCheckpointStore as JDiskStore  # noqa: E402
from repro.checkpoint.reshard import flatten_tree as jflatten  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.core.job import JobSpec as JJobSpec  # noqa: E402
from repro.core.policies import PolicyConfig as JPolicyConfig  # noqa: E402
from repro.obs.audit import audit_records  # noqa: E402
from repro_torch.checkpoint import DiskCheckpointStore as PDiskStore  # noqa: E402
from repro_torch.checkpoint.reshard import flatten_tree  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.job import JobSpec as PJobSpec  # noqa: E402
from repro_torch.core.policies import PolicyConfig as PPolicyConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

TOL = 5e-5
DIVISORS = (1, 2, 4, 8)
PACKAGES = {
    "jax": dict(ctl=jop.ElasticClusterController, spec=JJobSpec,
                policy=JPolicyConfig, timings=jel.RescaleTimings,
                tracer=jtrace.Tracer, devices=lambda n: list(range(n)),
                ids=lambda devs: [int(d) for d in devs]),
    "torch": dict(ctl=pop.ElasticClusterController, spec=PJobSpec,
                  policy=PPolicyConfig, timings=pel.RescaleTimings,
                  tracer=ptrace.Tracer, devices=pel.local_slots,
                  ids=lambda devs: [d.id for d in devs]),
}


class _Stub:
    """Duck-typed trainer: counts steps, records every slot set it is given,
    and keeps its "disk checkpoint" as a step number in a dict store."""

    def __init__(self, pkg, total_steps, devices, log):
        self.pkg, self.total_steps, self.step_idx = pkg, total_steps, 0
        self.log = log
        self.log.append(("create", tuple(pkg["ids"](devices))))

    @property
    def done(self):
        return self.step_idx >= self.total_steps

    def step(self):
        self.step_idx += 1

    def rescale(self, devices):
        self.log.append(("rescale", tuple(self.pkg["ids"](devices))))
        return self.pkg["timings"]()

    def save_disk(self, store, job_id):
        store[job_id] = self.step_idx

    def restore_disk(self, store, job_id):
        if job_id not in store:
            raise FileNotFoundError(job_id)
        self.step_idx = store[job_id]
        self.log.append(("restore", self.step_idx))
        return self.step_idx


def _step_time(job):
    return 1.0 + 0.25 * job.replicas


def _run(pkg_name, jobs, script=None, store=False, **kw):
    """Run ``jobs`` [(JobSpec args, kwargs, total_steps, checkpoint_every)]
    through one package's controller; ``script(op)`` runs before ``run()``."""
    pkg = PACKAGES[pkg_name]
    tracer = pkg["tracer"]()
    kw.setdefault("slots", 8)
    op = pkg["ctl"](pkg["devices"](kw["slots"]),
                    policy=pkg["policy"](rescale_gap=kw.pop("rescale_gap", 0.0)),
                    step_time_fn=_step_time, tracer=tracer,
                    disk_store={} if store else None, **kw)
    logs = {}
    for args, spec_kw, steps, every in jobs:
        log = logs.setdefault(args[0], [])
        op.submit(pkg["spec"](*args, **spec_kw),
                  lambda devs, s=steps, log=log: _Stub(pkg, s, devs, log),
                  checkpoint_every=every)
    if script is not None:
        script(op)
    m = op.run()
    events = [(t, j, a, b) for t, j, a, b, _ in op.rescale_events]
    return dict(events=events, trace=list(op.replica_trace),
                metrics=m.to_dict(), records=tracer.records, logs=logs,
                failures={j: live.failures for j, live in op.live.items()})


def _fail_after_steps(job_id, n):
    """operator_scenario.py's scenario 2: steps by hand, a checkpoint, then
    the failure."""
    def script(op):
        op._process_submissions()
        trainer = op.live[job_id].trainer
        for _ in range(n):
            trainer.step()
        trainer.save_disk(op.disk_store, job_id)
        op.inject_failure(job_id)
    return script


def _node_failure_and_recover(op):
    op._process_submissions()
    home = [n for n in op.cluster.nodes() if "a" in op.cluster.residents(n)]
    op.inject_node_failure(home[0])
    op.recover_node(home[0])


def _drain_and_recover(op):
    op._process_submissions()
    home = [n for n in op.cluster.nodes() if "a" in op.cluster.residents(n)]
    op.drain_node(home[0])
    op.recover_node(home[0])


SCENARIOS = {
    # tests/helpers/operator_scenario.py, scenario 1
    "priority_shrink_expand": dict(
        jobs=[(("low", 1, 2, 8, 0.0), dict(divides=8), 20, 0),
              (("high", 5, 4, 8, 0.001), dict(divides=8), 8, 0)],
        steps_per_tick=2),
    # tests/helpers/operator_scenario.py, scenario 2
    "restart_from_disk": dict(
        jobs=[(("victim", 3, 2, 4, 0.0), dict(divides=8), 20, 4)],
        steps_per_tick=2, store=True, script=_fail_after_steps("victim", 6)),
    "node_failure_recover": dict(
        jobs=[(("a", 2, 2, 4, 0.0), dict(divides=8), 12, 3),
              (("b", 1, 2, 4, 0.0), dict(divides=8), 10, 0),
              (("c", 4, 2, 8, 6.0), dict(divides=8), 6, 0)],
        slots_per_node=4, store=True, script=_node_failure_and_recover),
    "drain_slots_per_node_4": dict(
        jobs=[(("a", 1, 2, 4, 0.0), dict(divides=8), 12, 0),
              (("b", 3, 2, 2, 0.0), dict(divides=8), 8, 0),
              (("c", 2, 1, 2, 3.0), dict(divides=8), 5, 0)],
        slots_per_node=4, script=_drain_and_recover),
}


def _random_jobs(seed):
    rng = np.random.default_rng(seed)
    jobs = []
    for i in range(int(rng.integers(3, 8))):
        lo, hi = sorted(rng.choice(DIVISORS, size=2))
        jobs.append(((f"j{i}", int(rng.integers(1, 6)), int(lo), int(hi),
                      float(np.round(rng.uniform(0.0, 20.0), 3))),
                     dict(divides=8), int(rng.integers(2, 16)),
                     int(rng.choice([0, 3]))))
    return jobs


def _assert_same(a, b):
    assert a["events"] == b["events"]
    assert a["trace"] == b["trace"]
    assert a["metrics"] == b["metrics"]
    assert a["records"] == b["records"]
    assert a["logs"] == b["logs"]
    assert a["failures"] == b["failures"]


def _assert_audit_passes(records):
    reports = audit_records(records, source="repro_torch operator")
    assert reports and all(r.ok for r in reports), \
        "\n".join(r.summary() for r in reports)


@pytest.mark.parametrize("placement", ["pack", "spread"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_stub_scenarios_match_the_jax_operator(name, placement):
    sc = dict(SCENARIOS[name])
    jobs = sc.pop("jobs")
    runs = {pkg: _run(pkg, jobs, placement=placement, **sc) for pkg in PACKAGES}
    _assert_same(runs["jax"], runs["torch"])
    _assert_audit_passes(runs["torch"]["records"])
    assert runs["torch"]["metrics"]["counters"]["completions"] == len(jobs)


@pytest.mark.parametrize("placement", ["pack", "spread"])
@pytest.mark.parametrize("seed", range(8))
def test_random_job_sets_match_the_jax_operator(seed, placement):
    jobs = _random_jobs(seed)
    kw = dict(placement=placement, slots_per_node=4,
              steps_per_tick=int(1 + seed % 3), store=True)
    if seed % 2:       # odd seeds: a node fails and recovers before the run
        kw["script"] = _node_failure_and_recover_any
    runs = {pkg: _run(pkg, jobs, **kw) for pkg in PACKAGES}
    _assert_same(runs["jax"], runs["torch"])
    _assert_audit_passes(runs["torch"]["records"])


def _node_failure_and_recover_any(op):
    op._process_submissions()
    busy = [n for n in op.cluster.nodes() if op.cluster.residents(n)]
    if busy:
        op.inject_node_failure(busy[0])
        op.recover_node(busy[0])


def test_scenario_checks_reach_their_subjects():
    """The scenarios exercise what their names say: a shrink then an expand,
    a restore from the store, a failure, a drain migration."""
    sc = dict(SCENARIOS["priority_shrink_expand"])
    run = _run("torch", sc.pop("jobs"), **sc)
    moves = [(a, b) for _, j, a, b in run["events"] if j == "low"]
    assert moves[0][0] > moves[0][1] and moves[-1][0] < moves[-1][1]
    sc = dict(SCENARIOS["restart_from_disk"])
    run = _run("torch", sc.pop("jobs"), **sc)
    assert ("restore", 6) in run["logs"]["victim"] and run["failures"]["victim"] == 1
    sc = dict(SCENARIOS["drain_slots_per_node_4"])
    run = _run("torch", sc.pop("jobs"), **sc)
    kinds = [r["kind"] for r in run["records"]]
    assert "job_migrate" in kinds or "job_rescale" in kinds
    assert "node_cordon" in kinds and "node_uncordon" in kinds


# -- (b) phase 7's scenario functions on the CPU ---------------------------------

SMOKE_JOB = dict(global_batch=8, seq_len=16)


@pytest.fixture
def jax_references(tmp_path, monkeypatch):
    """Single-device JAX trainers of each (arch, job), run to their end, and
    a factory for chip_smoke's scenarios whose port trainers start from the
    JAX trainer's initial state (a step-0 checkpoint: the two packages draw
    their initial weights from different generators)."""
    refs, init_dir = {}, str(tmp_path / "init")

    def reference(cfg, job):
        key = (cfg.name, job.seed)
        if key not in refs:
            arch = cfg.name.removesuffix("-smoke")
            jt = jel.ElasticTrainer(jsmoke_config(arch),
                                    jel.TrainJobConfig(**dataclasses.asdict(job)),
                                    jax.devices()[:1])
            jt.save_disk(JDiskStore(init_dir), f"{arch}-{job.seed}")
            while not jt.done:
                jt.step()
            refs[key] = jt
        return refs[key]

    def factory(cfg, job, device):
        name = f"{cfg.name.removesuffix('-smoke')}-{job.seed}"
        reference(cfg, job)

        def make(slots):
            t = pel.ElasticTrainer(cfg, job, slots, device=device)
            assert t.restore_disk(PDiskStore(init_dir), name) == 0
            return t
        return make
    monkeypatch.setattr(chip_smoke, "trainer_factory", factory)
    return reference


def _assert_matches_jax(trainer, jt):
    ref = jflatten(jax.device_get(jt.params))
    got = flatten_tree(trainer.params)
    assert list(got) == list(ref)
    err = max(float(np.max(np.abs(got[k].detach().numpy() - np.asarray(ref[k]))))
              for k in got)
    assert err < TOL, (trainer.cfg.name, err)
    losses = {m["step"]: m["loss"] for m in trainer.metrics_log}
    lerr = max(abs(losses[m["step"]] - m["loss"]) for m in jt.metrics_log
               if m["step"] in losses)
    assert lerr < TOL, (trainer.cfg.name, lerr)


def test_scenario_a_matches_a_single_device_jax_trainer(jax_references):
    cfg = smoke_config("yi-6b")
    low = pel.TrainJobConfig(total_steps=10, seed=0, **SMOKE_JOB)
    high = pel.TrainJobConfig(total_steps=4, seed=1, **SMOKE_JOB)
    with ptrace.install(ptrace.Tracer()) as tracer:
        op, m = chip_smoke.scenario_priority(cfg, low, high, "cpu")
    assert [x["replicas"] for x in op.live["low"].trainer.metrics_log] == \
        [8, 8, 2, 2, 2, 2, 8, 8, 8, 8]
    assert m.rescale_count == 2 and chip_smoke.live_trainers(op) == 2
    _assert_audit_passes(tracer.records)
    _assert_matches_jax(op.live["low"].trainer, jax_references(cfg, low))
    _assert_matches_jax(op.live["high"].trainer, jax_references(cfg, high))
    static = chip_smoke.static_run(cfg, low, "cpu")
    lerr = max(abs(a["loss"] - b["loss"]) for a, b in
               zip(op.live["low"].trainer.metrics_log, static.metrics_log))
    assert lerr <= chip_smoke.TRAJ_LOSS_TOL


def test_scenario_b_restarts_from_the_async_checkpoint_and_drains_on_the_host_lane(
        tmp_path, jax_references):
    victim_cfg, neighbor_cfg = smoke_config("mamba2-1.3b"), smoke_config("yi-6b")
    victim = pel.TrainJobConfig(total_steps=4, seed=2, **SMOKE_JOB)
    neighbor = pel.TrainJobConfig(total_steps=4, seed=3, **SMOKE_JOB)
    with ptrace.install(ptrace.Tracer()) as tracer:
        op, m, dropped, timings = chip_smoke.scenario_faults(
            victim_cfg, victim, neighbor_cfg, neighbor, "cpu", str(tmp_path / "ckpt"))
    _assert_audit_passes(tracer.records)
    kinds = [r["kind"] for r in tracer.records]
    assert kinds.count("job_fail") == 1 and kinds.count("job_migrate") == 1
    assert [r for r in tracer.records if r["kind"] == "job_start"
            and r["job"] == "victim"][-1]["resume"] is True
    assert timings["ckpt_step"] == 1 and timings["snapshot_packs"] == 2
    assert dropped["replicas"] == [4, 4] and dropped["host_packs"] == 0
    assert [r.path for r in op.live["neighbor"].trainer.rescale_log] == ["host"]
    resumed = op.live["victim"].trainer
    assert [x["step"] for x in resumed.metrics_log] == [2, 3, 4]
    # the restarted victim and the migrated neighbor end where uninterrupted
    # single-device JAX runs end
    _assert_matches_jax(resumed, jax_references(victim_cfg, victim))
    _assert_matches_jax(op.live["neighbor"].trainer,
                        jax_references(neighbor_cfg, neighbor))
    records = [chip_smoke.trainer_record(live.trainer) for live in op.live.values()]
    expected = chip_smoke.expected_launches(records + [dropped], timings["snapshot_packs"])
    assert expected == {"flash_attention": 2 * 2 * 4 * 4, "pack": 2 + 3,
                        "rmsnorm": 0, "ssd": 2 * 2 * 4 * 5}
