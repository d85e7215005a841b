"""The port's own spans in the traced window: a trainer under
``torch.profiler`` records into the port's profiled recorder, which the
first reader of a run flushes; the seven readers of spans and counters on
made-up records whose answers are worked by hand; and (on the card) the
spans' clock against the profiler's."""
from types import SimpleNamespace

import pytest

from bench import program, spec, trace

MS = 1_000_000
READERS = ("optimizer_s", "recompute_s", "moe_dispatch_s", "moe_experts_s",
           "moe_combine_s", "moe_slot_fill", "host_lane_gbps")


def _span(name, t0, t1, phase="forward", device_s=None):
    return {"name": name, "phase": phase, "t0_ns": t0 * MS, "t1_ns": t1 * MS,
            "device_s": device_s}


def test_a_profiled_trainer_records_its_spans_for_the_readers():
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import smoke_config
    from repro_torch.core.elastic import ElasticTrainer, Slot, TrainJobConfig, local_slots
    from repro_torch.obs import device_spans as ds
    job = TrainJobConfig(global_batch=4, seq_len=16, total_steps=4, seed=5, dtype="float32")
    tr = ElasticTrainer(smoke_config("granite-moe-3b-a800m"), job, local_slots(2),
                        device="cpu")
    if ds.profiled_recorder() is not None:
        ds.profiled_recorder().flush()
    tr.step()                                   # no profiler: nothing recorded
    with profile(activities=[ProfilerActivity.CPU]):
        tr.step()
        tr.rescale([Slot(7)])
        tr.step()
    tr.step()                                   # the profiler gone: taken down
    assert ds.current_recorder() is ds.NULL_RECORDER
    assert program.of(SimpleNamespace()) is None          # an untraced run reads nothing
    run = SimpleNamespace(trace={})
    got = program.of(run)
    assert program.of(run) is got and ds.profiled_recorder().flush()["spans"] == []
    steps = [s["step"] for s in got["spans"] if s["name"] == "trainer.step"]
    assert steps == [1, 2]
    assert [s["name"] for s in got["spans"] if s["name"].startswith("trainer.r")] == [
        "trainer.rescale"]
    assert {s["phase"] for s in got["spans"] if s["name"] == "model.layer"} == {
        "forward", "recompute"}
    assert all(s["device_s"] is None for s in got["spans"])      # no card: no device time
    assert 0 < spec.reader("moe_slot_fill").read(run) < 100
    assert got["counters"]["host_lane.bytes_h2d"] > 0
    assert spec.reader("optimizer_s").read(run) is None


def _run(spans, counters):
    return SimpleNamespace(program={"spans": spans, "counters": counters})


def _window():
    """Two steps: each an optimizer of 0.1 s, two recomputed layers of 0.2 s
    and a forward one of 0.3 s, a dispatch in three phases, one experts and
    one combine span; one rescale's copies, 1 GB in 0.02 s and 1.5 GB in
    0.03 s."""
    spans = []
    for step in range(2):
        spans += [_span("trainer.step", 0, 1, device_s=5.0),
                  _span("trainer.optimizer", 0, 1, device_s=0.1),
                  _span("model.layer", 0, 1, device_s=0.3),
                  _span("model.layer", 0, 1, "recompute", device_s=0.2),
                  _span("model.layer", 0, 1, "recompute", device_s=0.2),
                  _span("model.moe.dispatch", 0, 1, device_s=0.01),
                  _span("model.moe.dispatch", 0, 1, "recompute", device_s=0.01),
                  _span("model.moe.dispatch", 0, 1, "backward", device_s=0.02),
                  _span("model.moe.experts", 0, 1, device_s=0.5),
                  _span("model.moe.combine", 0, 1, "backward", device_s=0.03)]
    spans += [_span("rescale.copy_d2h", 0, 1, device_s=0.02),
              _span("rescale.copy_h2d", 0, 1, device_s=0.03)]
    counters = {"moe.kept": 13_107, "moe.slots": 16_384,
                "host_lane.bytes_d2h": 1_000_000_000, "host_lane.bytes_h2d": 1_500_000_000}
    return _run(spans, counters)


def test_each_reader_gives_its_value():
    run = _window()
    got = {name: spec.reader(name).read(run) for name in READERS}
    assert got == {"optimizer_s": pytest.approx(0.1), "recompute_s": pytest.approx(0.4),
                   "moe_dispatch_s": pytest.approx(0.04), "moe_experts_s": pytest.approx(0.5),
                   "moe_combine_s": pytest.approx(0.03),
                   "moe_slot_fill": pytest.approx(100 * 13_107 / 16_384),
                   "host_lane_gbps": pytest.approx(50.0)}


@pytest.mark.parametrize("run", [
    SimpleNamespace(),                                    # a run of an older driver
    SimpleNamespace(program=None),                        # untraced, or a port without spans
    _run([], {}),
    _run([_span("trainer.step", 0, 1, device_s=5.0)], {}),  # a step with none of the spans
    _run([_span("trainer.optimizer", 0, 1, device_s=None),
          _span("trainer.step", 0, 1, device_s=None)], {}),  # spans without device time
], ids=["no-field", "none", "empty", "step-only", "cpu"])
def test_each_reader_is_silent_without_its_spans(run):
    assert {name: spec.reader(name).read(run) for name in READERS} == dict.fromkeys(READERS)


@pytest.mark.cuda
def test_a_spans_clock_is_the_profilers():
    """Under ``torch.profiler`` with CUDA activity, the kernels launched
    inside a span start after its ``t0_ns``, the first of them within 5 ms of
    it and before its ``t1_ns``, and its ``device_s``, from events of the
    recorder's pool, is within 5% of the union of their intervals."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.obs import device_spans as ds
    a = torch.randn(4096, 4096, device="cuda")
    for _ in range(3):
        a @ a
    torch.cuda.synchronize()
    rec = ds.SpanRecorder("cuda", reserve=1)
    with ds.install(rec):                   # the reserved pair, given back
        with ds.span("warm"):
            a @ a
    (warm,) = rec.flush()["spans"]
    assert warm["device_s"] > 0
    with trace.Window() as window, ds.install(rec):
        with ds.span("work"):
            for _ in range(20):
                a @ a
        torch.cuda.synchronize()
    (span,) = rec.flush()["spans"]
    kernels = window.reduce([], span["t0_ns"], span["t1_ns"])["kernels"]
    assert len(kernels) >= 20, kernels
    assert all(k[0] > span["t0_ns"] for k in kernels)
    assert kernels[0][0] < span["t1_ns"] and kernels[0][0] - span["t0_ns"] < 5_000_000
    busy = sum(e - b for b, e in trace._union([k[:2] for k in kernels], 0, 1 << 62)) / 1e9
    assert span["device_s"] == pytest.approx(busy, rel=0.05)


@pytest.mark.cuda
def test_each_step_reuses_the_event_pairs_the_card_has_passed():
    """As a ``trainer.step`` opens, the pairs of the spans closed before it
    are read and handed back: three steps run on one pair, and each keeps
    its device time."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.obs import device_spans as ds
    a = torch.randn(2048, 2048, device="cuda")
    rec = ds.SpanRecorder("cuda")
    with ds.install(rec):
        for i in range(3):
            with ds.span("trainer.step", i):
                a @ a
            torch.cuda.synchronize()
    spans = rec.flush()["spans"]
    assert [s["step"] for s in spans] == [0, 1, 2]
    assert all(s["device_s"] > 0 for s in spans)
    assert len(rec._pool) == 1
