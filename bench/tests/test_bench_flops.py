"""The yardstick's counts against counts worked by hand."""
import pytest

from bench import flops, spec

# yi-6b at depth 4: attention d*hd*(H + 2 KV) + H*hd*d = 4096*128*40 +
# 32*128*4096 = 37,748,736; SwiGLU 3*4096*11008 = 135,266,304; four layers
# 692,060,160; the head 4096*64000 = 262,144,000
YI_ACTIVE = 954_204_160
# granite: attention 1536*64*40 + 24*64*1536 = 6,291,456; eight experts
# 8*3*1536*512 = 18,874,368; the router 1536*40 = 61,440; 32 layers
# 807,272,448; the tied head 1536*49155 = 75,502,080
GRANITE_ACTIVE = 882_774_528
PAIRS = 2048 * 2049 // 2            # causal (query, key) pairs of one sequence


@pytest.mark.parametrize("name,active,heads,hd,layers", [
    ("yi-6b.d4.fp32", YI_ACTIVE, 32, 128, 4),
    ("granite-moe-3b-a800m.fp32", GRANITE_ACTIVE, 24, 64, 32)])
def test_model_flops_of_a_step(bench_json, name, active, heads, hd, layers):
    cfg = spec.config(bench_json, name)
    assert flops.active_matmul_params(cfg) == active
    attn_fwd = 4 * 8 * heads * hd * PAIRS          # QK^T and PV, 8 sequences
    want = 6 * active * 8 * 2048 + 3 * layers * attn_fwd
    assert flops.train_step_flops(cfg, 8, 2048, layers) == want
    assert flops.causal_attention_ops(8, 2048, heads, hd) == attn_fwd


def test_yi_step_is_about_9_7e13_and_granite_9_7e13(bench_json):
    yi = flops.train_step_flops(spec.config(bench_json, "yi-6b.d4.fp32"), 8, 2048, 4)
    gr = flops.train_step_flops(spec.config(bench_json, "granite-moe-3b-a800m.fp32"),
                                8, 2048, 32)
    assert yi == pytest.approx(9.7102e13, rel=1e-4)
    assert gr == pytest.approx(9.6681e13, rel=1e-4)


def test_flash_bytes_and_bound_at_the_training_shard():
    # yi's R=4 shard: B 2, S 2048, H 32, KV 4, hd 128, float32
    b = flops.flash_fwd_bytes(2, 2048, 32, 4, 128)
    assert b == 4 * 2 * 2048 * 128 * (32 + 32 + 4 + 4) + 4 * 2 * 32 * 2048
    ops = flops.causal_attention_ops(2, 2048, 32, 128)
    peak = flops.peak("NVIDIA H100 80GB HBM3", "float32")
    assert ops / peak * 1e3 == pytest.approx(1.0262, rel=1e-4)   # ms, compute-bound
    assert b / flops.peak("NVIDIA H100 80GB HBM3", "hbm_bytes_per_s") < ops / peak


def test_no_peak_for_an_unknown_card():
    assert flops.peak("cpu", "float32") is None
