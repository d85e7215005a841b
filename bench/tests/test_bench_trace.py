"""The traced window's reduction and the readers of the device trace, on
made-up events whose answers are worked by hand."""
from types import SimpleNamespace

import pytest

from bench import flops, spec, trace

MS = 1_000_000


def _window():
    # window [0, 100 ms]; kernels [10, 30], [20, 40] (overlapping), [60, 70]
    device = [(10 * MS, 30 * MS, "gemm"), (20 * MS, 40 * MS, "flash_fwd_f32_kernel<128>"),
              (60 * MS, 70 * MS, "gemm")]
    spans = [(5 * MS, 45 * MS, "bench.step"), (50 * MS, 90 * MS, "bench.rescale")]
    return trace.reduce_events(device, spans, 0, 100 * MS)


def test_busy_time_is_the_union_of_device_intervals():
    r = _window()
    assert r["window_s"] == pytest.approx(0.1)
    assert r["busy_s"] == pytest.approx(0.040)      # [10, 40] and [60, 70]
    ops = dict((n, s) for n, s in r["device_ops"])
    assert ops["gemm"] == pytest.approx(0.030)


def test_idle_gaps_are_named_by_the_span_they_fall_in():
    gaps = dict((n, s) for n, s in _window()["idle_gaps"])
    assert gaps["bench.step"] == pytest.approx(0.010)             # [0, 10], middle 5
    assert gaps["bench.rescale"] == pytest.approx(0.050)          # [40, 60] and [70, 100]
    assert sum(gaps.values()) == pytest.approx(0.060)
    r = trace.reduce_events([(0, 20 * MS, "k"), (20 * MS + 5000, 30 * MS, "k")],
                            [(0, 30 * MS, "bench.step")], 0, 40 * MS)
    gaps = dict((n, s) for n, s in r["idle_gaps"])
    assert gaps == {"between spans": pytest.approx(0.010),
                    "gaps under 10 us": pytest.approx(5e-6)}


def _run(bench_json, kernels, replicas=(4,)):
    cfg = spec.config(bench_json, "yi-6b.d4.fp32")
    spans = [(i * 100 * MS, (i + 1) * 100 * MS - 1, "bench.step")
             for i in range(len(replicas))]
    return SimpleNamespace(
        cfg=cfg, traffic=spec.traffic("steady"), ref=spec.reference("decoder"),
        device_name="NVIDIA H100 80GB HBM3",
        steps=[{"seconds": 3.0, "replicas": r, "tokens": 16384} for r in replicas],
        trace={"kernels": sorted(kernels), "spans": spans, "busy_s": 0.5, "window_s": 2.0})


def test_flash_roofline_counts_a_launch_a_layer_and_shard(bench_json):
    # 2 passes x 4 layers x 4 shards = 32 launches of 2.0524 ms: half the bound
    bound_ms = flops.causal_attention_ops(2, 2048, 32, 128) / 67e12 * 1e3
    kernels = [(i * 3 * MS, i * 3 * MS + int(2 * bound_ms * MS), "flash_fwd_f32_kernel<128>")
               for i in range(32)]
    run = _run(bench_json, kernels)
    assert spec.reader("flash_roofline").read(run) == pytest.approx(50.0, rel=1e-5)
    assert spec.reader("device_idle_share").read(run) == pytest.approx(75.0)


def test_flash_roofline_is_silent_where_the_launches_are_no_whole_pass(bench_json):
    kernels = [(i * MS, i * MS + MS // 2, "flash_fwd_f32_kernel<128>") for i in range(5)]
    assert spec.reader("flash_roofline").read(_run(bench_json, kernels)) is None
    assert spec.reader("flash_roofline").read(_run(bench_json, [])) is None


def test_mfu_of_a_yi_step(bench_json):
    run = _run(bench_json, [])
    want = 100 * flops.train_step_flops(run.cfg, 8, 2048, 4) / (3.0 * 67e12)
    assert spec.reader("train_mfu").read(run) == pytest.approx(want)
    assert 40 < want < 55
