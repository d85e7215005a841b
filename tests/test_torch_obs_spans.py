"""The port's spans and counters (``repro_torch.obs.device_spans``) on the
CPU: off they record nothing; on they nest, share their step and carry the
phase autograd gives; the smoke trainers open them where the work happens,
the MoE counters agree with the dispatch's own tables, and a rescale's
stage spans are its ``RescaleTimings``."""
import threading

import pytest

torch = pytest.importorskip("torch")

from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.elastic import (ElasticTrainer, Slot,  # noqa: E402
                                      TrainJobConfig, local_slots)
from repro_torch.models import moe  # noqa: E402
from repro_torch.obs import device_spans as ds  # noqa: E402

JOB = dict(global_batch=4, seq_len=16, total_steps=4, seed=5, dtype="float32")
STAGES = ("load_balance", "checkpoint", "restart", "restore")


def _trainer(arch, slots=2):
    return ElasticTrainer(smoke_config(arch), TrainJobConfig(**JOB), local_slots(slots),
                          device="cpu")


def _by_name(out, name):
    return [s for s in out["spans"] if s["name"] == name]


def test_the_recorder_off_records_nothing_and_hands_out_one_no_op():
    assert ds.current_recorder() is ds.NULL_RECORDER and not ds.NULL_RECORDER.enabled
    a, b = ds.span("trainer.step", 3), ds.span("model.layer", attrs={"shard": 1})
    assert a is b is ds.NO_SPAN
    with a as entered:
        ds.count("moe.kept", 7)
    assert entered is ds.NO_SPAN
    rec = ds.SpanRecorder()
    with ds.install(rec):
        assert ds.current_recorder() is rec and ds.span("x") is not ds.NO_SPAN
    assert ds.current_recorder() is ds.NULL_RECORDER
    assert rec.flush() == {"spans": [], "counters": {}}


class _Twice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return 2 * x

    @staticmethod
    def backward(ctx, g):
        with ds.span("grad"):
            return 2 * g


def _other():
    with ds.span("other"):
        pass


def test_spans_nest_with_their_parents_steps_and_phases():
    def layer(x):
        with ds.span("layer"):
            return _Twice.apply(x).sin()

    rec = ds.SpanRecorder()
    x = torch.randn(3, requires_grad=True)
    with ds.install(rec):
        with ds.span("trainer.step", 7):
            with ds.span("trainer.forward", attrs={"shard": 0}):
                y = checkpoint(layer, x, use_reentrant=False)
            with ds.span("trainer.backward"):
                y.sum().backward()
                t = threading.Thread(target=_other)
                t.start()
                t.join(timeout=10)
                assert not t.is_alive()
        with ds.span("trainer.step", 8):
            pass
        ds.count("c", 2)
        ds.count("c", torch.tensor(3))
    out = rec.flush()
    ids = {s["id"]: s for s in out["spans"]}
    parent = lambda s: ids[s["parent"]]["name"] if s["parent"] else None
    got = [(s["name"], parent(s), s["step"], s["phase"]) for s in out["spans"]]
    assert got == [("trainer.step", None, 7, "forward"),
                   ("trainer.forward", "trainer.step", 7, "forward"),
                   ("layer", "trainer.forward", 7, "forward"),
                   ("trainer.backward", "trainer.step", 7, "forward"),
                   ("layer", "trainer.backward", 7, "recompute"),
                   ("grad", "trainer.backward", 7, "backward"),
                   ("other", "trainer.backward", 7, "forward"),
                   ("trainer.step", None, 8, "forward")]
    assert out["spans"][1]["shard"] == 0
    assert all(s["t0_ns"] <= s["t1_ns"] and s["device_s"] is None for s in out["spans"])
    for s in out["spans"]:
        if s["parent"]:
            p = ids[s["parent"]]
            assert p["t0_ns"] <= s["t0_ns"] and s["t1_ns"] <= p["t1_ns"]
    assert out["counters"] == {"c": 5}


def test_a_dense_step_opens_every_trainer_span_and_each_layer_twice():
    tr = _trainer("yi-6b")
    rec = ds.SpanRecorder()
    with ds.install(rec):
        tr.step()
    out = rec.flush()
    names = [s["name"] for s in out["spans"]]
    for name, n in [("trainer.step", 1), ("trainer.batch", 1), ("trainer.forward", 2),
                    ("trainer.backward", 2), ("trainer.optimizer", 1),
                    ("trainer.metrics", 1)]:
        assert names.count(name) == n, name
    assert [s["shard"] for s in _by_name(out, "trainer.forward")] == [0, 1]
    assert {s["step"] for s in out["spans"]} == {0}
    layers = _by_name(out, "model.layer")
    per_shard = tr.cfg.num_layers
    assert [s["phase"] for s in layers] == (["forward"] * per_shard
                                            + ["recompute"] * per_shard) * 2
    ids = {s["id"]: s["name"] for s in out["spans"]}
    assert {ids[s["parent"]] for s in layers if s["phase"] == "forward"} == {"trainer.forward"}
    assert {ids[s["parent"]] for s in layers if s["phase"] == "recompute"} == {
        "trainer.backward"}


def test_a_moe_steps_counters_are_the_dispatch_tables_own(monkeypatch):
    tables = []
    apply = moe._Dispatch.apply

    def spy(x, tok_of_slot, slot_of_asg, k):
        if ds.phase() == "forward":
            tables.append((slot_of_asg.clone(), tok_of_slot.numel()))
        return apply(x, tok_of_slot, slot_of_asg, k)
    monkeypatch.setattr(moe._Dispatch, "apply", spy)
    tr = _trainer("granite-moe-3b-a800m")
    rec = ds.SpanRecorder()
    with ds.install(rec):
        tr.step()
    out = rec.flush()
    cfg = tr.cfg
    assert len(tables) == 2 * cfg.num_layers             # each layer, each shard
    assert out["counters"] == {
        "moe.kept": sum(int((s < n).sum()) for s, n in tables),
        "moe.slots": sum(n for _, n in tables),
        "moe.rows": sum(n for _, n in tables)}      # the plain products: every slot
    assignments = JOB["global_batch"] * JOB["seq_len"] * cfg.moe.experts_per_token
    assert sum(s.numel() for s, _ in tables) == assignments * cfg.num_layers
    assert 0 < out["counters"]["moe.kept"] < assignments * cfg.num_layers
    phases = {(s["name"], s["phase"]) for s in out["spans"] if s["name"].startswith("model.moe")}
    assert phases == {(f"model.moe.{n}", p) for n in ("dispatch", "experts", "combine")
                      for p in ("forward", "recompute")} | {
        ("model.moe.dispatch", "backward"), ("model.moe.combine", "backward")}


@pytest.mark.parametrize("installed", [True, False])
def test_a_host_lane_rescales_stage_spans_are_its_timings(monkeypatch, installed):
    seen = []
    timed = ds.timed

    def keep(name, step=None, attrs=None):
        seen.append(timed(name, step, attrs))
        return seen[-1]
    monkeypatch.setattr("repro_torch.core.elastic.timed", keep)
    tr = _trainer("yi-6b")
    rec = ds.SpanRecorder()
    with ds.install(rec) if installed else ds.install(ds.NULL_RECORDER):
        t = tr.rescale([Slot(7)])
    assert t.path == "host"
    assert [s.name for s in seen] == [f"rescale.{k}" for k in STAGES]
    for k, s in zip(STAGES, seen):
        assert getattr(t, k) == s.seconds == (s.c1_ns - s.c0_ns) / 1e9 >= 0
        assert s.t0_ns <= s.t1_ns
    out = rec.flush()
    if not installed:
        assert out == {"spans": [], "counters": {}}
        return
    ids = {s["id"]: s["name"] for s in out["spans"]}
    kids = [s["name"] for s in out["spans"] if ids.get(s["parent"]) == "trainer.rescale"]
    assert kids == [f"rescale.{k}" for k in STAGES] + ["rescale.free"]
    assert t.total == pytest.approx(sum(
        s["host_s"] for s in out["spans"]
        if s["name"] in {f"rescale.{k}" for k in STAGES}), abs=1e-12)
    below = lambda stage: {s["name"] for s in out["spans"] if ids.get(s["parent"]) == stage}
    assert below("rescale.checkpoint") == {"rescale.pack", "rescale.pin", "rescale.copy_d2h"}
    assert below("rescale.restore") == {"rescale.copy_h2d"}
    state = sum(p.numel() * p.element_size() for tree in (tr.params, tr.opt_state)
                for p in _leaves(tree))
    assert out["counters"]["host_lane.bytes_h2d"] == state
    assert out["counters"]["host_lane.bytes_d2h"] >= state


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]
