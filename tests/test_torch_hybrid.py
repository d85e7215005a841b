"""The port's hybrid layout (jamba-v0.1-52b) against the JAX package on the
CPU: period-8 blocks ``sub0..sub7`` (Mamba-2 mixers with attention at sub3,
MoE of 16 experts top-2 on the odd subs, dense SwiGLU on the even ones),
at one block, two blocks, and a depth of 10 (two prefix layers, then one
block whose sub1 is the attention layer): parameter keys and shapes, the
layer index each layer runs as, loss (aux included) and every gradient
under both MoE dispatches, the hybrid cache (``make_cache``, ``pad_cache``),
prefill, decode, decode from the reference's cache, teacher forcing; the
trainer through both lanes; full-width parameter counts and the arch model;
both CLIs; and ``chip_smoke.py``'s phase 14 at smoke size.

The reference runs as its own CPU tests run it: the jnp SSD and blocked
attention, ``jax.jit`` on ``prefill`` and ``decode_step``, and the MoE in
its dense form wherever decode is compared (``tests/test_models.py``).
Parameters cross with ``from_numpy_flat``.  Tolerances: fp32 forward,
prefill and cache 2e-5, gradients 1e-4, trajectories 5e-5, decode against
teacher forcing 2e-4 x max(1, max |logit|)."""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core.perf_model as jpm  # noqa: E402
from repro.checkpoint import DiskCheckpointStore as JDiskStore  # noqa: E402
from repro.checkpoint.reshard import flatten_tree as jflatten  # noqa: E402
from repro.configs import count_active_params as jcount_active  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.core.elastic import ElasticTrainer as JTrainer  # noqa: E402
from repro.core.elastic import TrainJobConfig as JJob  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.moe import set_moe_impl as jset_moe_impl  # noqa: E402
import repro_torch.core.perf_model as ppm  # noqa: E402
from repro_torch.checkpoint import DiskCheckpointStore, flatten_tree  # noqa: E402
from repro_torch.checkpoint.reshard import nest_flat  # noqa: E402
from repro_torch.configs import ATTN, FF_MOE, FF_SWIGLU, SSM  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core.elastic import (ElasticTrainer, TrainJobConfig,  # noqa: E402
                                      local_slots)
from repro_torch.data import make_stream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.moe import set_moe_impl  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "jamba-v0.1-52b"
TOL = 2e-5
GRAD_TOL = 1e-4
TRAJ_TOL = 5e-5
# a step-0 gradient below this (but not 0) is rounding (``_rounding``)
ROUNDING = 1e-7
TF_TOL = 2e-4
# a prompt of two chunks of the smoke config's SSD chunk 8, then GEN decode
# steps; the teacher-forced sequence (24 tokens) is a multiple of the chunk
B, S0, GEN = 2, 16, 8
JOB = dict(global_batch=8, seq_len=32, total_steps=12, seed=3)
# (layers_per_period, depth): one block; two blocks; two prefix layers and
# one block, whose sub1 is layer 3, the attention layer
LAYOUTS = {"one_block": (1, None), "two_blocks": (2, None), "prefix_block": (1, 10)}
# full width, cut in depth: (layers, parameters, active parameters), the JAX
# package's count_params and count_active_params
DEPTHS = [(1, 814_412_320, 814_412_320), (2, 3_734_426_688, 1_268_118_592),
          (4, 6_872_553_056, 1_939_936_864), (8, 13_267_656_416, 3_402_424_032),
          (32, 51_460_000_640, 11_999_071_104)]


def _tokens(a):
    return torch.from_numpy(np.ascontiguousarray(a)).long()


def _configs(layout, dtype="float32"):
    per_period, depth = LAYOUTS[layout]
    jcfg = jsmoke_config(ARCH, layers_per_period=per_period).with_(dtype=dtype)
    cfg = smoke_config(ARCH, layers_per_period=per_period).with_(dtype=dtype)
    if depth is not None:
        jcfg, cfg = jcfg.with_(num_layers=depth), cfg.with_(num_layers=depth)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _jax_params(jcfg):
    """The JAX package's parameters of ``jcfg`` (seed 0) and their numpy
    flat form, made once a config (the arrays are immutable)."""
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jparams, {k: np.asarray(v) for k, v in jflatten(jparams).items()}


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------

def _mamba2_period_2(cfg):
    """A hybrid built by hand: Mamba-2 with attention at every second layer
    (period 2), at a depth of 5, so layer 0 is a prefix layer, ``sub0`` the
    attention layers and ``sub1`` the SSM layers of two blocks."""
    return cfg.with_(attn_every=2, attn_offset=1, num_layers=5, num_heads=4,
                     num_kv_heads=2, head_dim=16, dtype="float32")


@pytest.mark.parametrize("layout", list(LAYOUTS) + ["mamba2_period_2"])
def test_param_keys_and_shapes_equal_flatten_tree(layout):
    if layout == "mamba2_period_2":
        jcfg = _mamba2_period_2(jsmoke_config("mamba2-1.3b"))
        cfg = _mamba2_period_2(smoke_config("mamba2-1.3b"))
        assert cfg.layer_period() == 2 and cfg.scan_layers() == (1, 4)
    else:
        jcfg, cfg = _configs(layout)
    want = {k: v.shape for k, v in jflatten(jax.eval_shape(
        lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))).items()}
    assert M.param_shapes(cfg) == want
    ours = flatten_tree(M.init_params(cfg, 0, device="cpu"))
    assert list(ours) == list(want)
    assert {k: tuple(v.shape) for k, v in ours.items()} == want
    assert M.param_count(cfg) == M.count_params(cfg) == JM.param_count(jcfg)


@pytest.mark.parametrize("layout,prefix,blocks", [
    ("one_block", 0, 1), ("two_blocks", 0, 2), ("prefix_block", 2, 1)])
def test_the_smoke_layouts_have_the_references_period_8_blocks(layout, prefix, blocks):
    """Attention at sub ``(3 - prefix) mod 8``, MoE on the subs whose layer
    ``prefix + j`` is odd; the prefix layers unstacked, layer 1 a MoE layer."""
    jcfg, cfg = _configs(layout)
    assert cfg.layer_period() == jcfg.layer_period() == 8
    assert cfg.scan_layers() == jcfg.scan_layers() == (prefix, 8 * blocks)
    keys = M.param_shapes(cfg)
    for j in range(8):
        sub = f"decoder/blocks/sub{j}/"
        attn, moe = (prefix + j) % 8 == 3, (prefix + j) % 2 == 1
        assert (sub + "mixer/wq" in keys) == attn, j
        assert (sub + "mixer/in_proj" in keys) != attn, j
        assert (sub + "ff/router" in keys) == moe, j
        assert keys[sub + "mixer_norm"] == (blocks, 64)
    assert keys["decoder/blocks/sub1/ff/w_gate"] == (blocks, 4, 64, 32)
    if prefix:
        assert keys["decoder/blocks/sub1/mixer/wq"] == (1, 64, 4, 16)
        assert keys["decoder/prefix/layer1/ff/w_gate"] == (4, 64, 32)     # MoE
        assert keys["decoder/prefix/layer0/ff/w_gate"] == (64, 128)       # dense
        assert keys["decoder/prefix/layer0/mixer/in_proj"][0] == 64


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_the_decoder_runs_each_layer_as_its_own_index(layout, monkeypatch):
    """The decoder runs the prefix layers, then block by block sub0..sub7,
    sub j as layer ``prefix + j`` (the index that picks its mixer and FFN),
    with the parameters of its own block, in every mode."""
    _, cfg = _configs(layout)
    prefix, n = cfg.scan_layers()
    params = M.init_params(cfg, 0, device="cpu")
    seen = []
    apply_layer = transformer.apply_layer

    def spy(cfg, p, x, i, **kw):
        seen.append((i, p["mixer_norm"].data_ptr()))
        return apply_layer(cfg, p, x, i, **kw)
    monkeypatch.setattr(transformer, "apply_layer", spy)
    norms = flatten_tree(params["decoder"])
    want = [(i, norms[f"prefix/layer{i}/mixer_norm"].data_ptr()) for i in range(prefix)]
    want += [(prefix + j, norms[f"blocks/sub{j}/mixer_norm"][b].data_ptr())
             for b in range(n // 8) for j in range(8)]
    tokens = _tokens(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 8)))
    M.loss_fn(cfg, params, {"tokens": tokens, "labels": tokens})
    assert seen == want
    seen.clear()
    M.prefill(cfg, params, {"tokens": tokens})
    assert seen == want


# ---------------------------------------------------------------------------
# training forward and backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["gather", "dense"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_loss_aux_and_every_gradient_match_jax(layout, impl):
    jcfg, cfg = _configs(layout)
    jparams, flat = _jax_params(jcfg)
    batch = make_stream(cfg, seed=1, global_batch=4, seq_len=32).global_batch_at(0)
    batch["labels"][0, :5] = -1
    jset_moe_impl(impl)
    set_moe_impl(impl)
    try:
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
            lambda p: JM.loss_fn(jcfg, p, jbatch), has_aux=True))(jparams)
        params = M.from_numpy_flat(flat, device="cpu")
        loss, m = M.loss_fn(cfg, params, {k: torch.from_numpy(v).long()
                                          for k, v in batch.items()})
        loss.backward()
    finally:
        jset_moe_impl("gather")
        set_moe_impl("gather")
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=TOL, rtol=TOL)
    aux = float(m["aux"].detach())
    np.testing.assert_allclose(aux, float(jm["aux"]), atol=TOL, rtol=TOL)
    assert aux > 0
    jg = {k: np.asarray(v) for k, v in jflatten(jgrads).items()}
    tg = flatten_tree(params)
    assert list(tg) == list(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k].grad.numpy(), jg[k], atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=k)


def test_moe_stats_come_from_the_moe_layers_in_layer_order(monkeypatch):
    """The decoder returns one (psum, counts) pair a MoE layer, those of the
    prefix layer 1, then of each block's odd subs, in layer order; each sums
    to the batch's tokens (psum) and to k times them (counts)."""
    _, cfg = _configs("prefix_block")
    params = M.init_params(cfg, 0, device="cpu")
    tokens = _tokens(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)))
    returned = []
    apply_layer = transformer.apply_layer

    def spy(cfg, p, x, i, **kw):
        out = apply_layer(cfg, p, x, i, **kw)
        returned.append((i, out[2]))
        return out
    monkeypatch.setattr(transformer, "apply_layer", spy)
    with torch.no_grad():
        _, stats = M.forward_hidden(cfg, params, {"tokens": tokens})
    moe = [(i, s) for i, s in returned if s is not None]
    assert [i for i, _ in moe] == [1, 3, 5, 7, 9]
    assert all(cfg.ff_at(i) == FF_MOE for i, _ in moe)
    assert len(stats) == len(moe) and all(a is b for a, (_, b) in zip(stats, moe))
    for psum, counts in stats:
        assert float(counts.sum()) == 2 * 16 * cfg.moe.experts_per_token
        assert abs(float(psum.sum()) - 2 * 16) < 1e-4


# ---------------------------------------------------------------------------
# the hybrid cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_and_pad_cache_match_the_references_keys_shapes_and_dtypes(layout, dtype):
    jcfg, cfg = _configs(layout, dtype)
    for prompt, window in ((5, 5), (5, 9), (3, 7)):
        ours = M.pad_cache(cfg, M.make_cache(cfg, 3, prompt, device="cpu"), prompt, window)
        want = JM.pad_cache(jcfg, JM.make_cache(jcfg, 3, prompt), prompt, window)
        ours = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in flatten_tree(ours).items()}
        want = {k: (v.shape, str(v.dtype)) for k, v in jflatten(want).items()}
        assert ours == want and list(ours) == list(want)
    prefix, n = cfg.scan_layers()
    attn = f"blocks/sub{(3 - prefix) % 8}/kv/"
    assert ours[attn + "k"] == ((n // 8, 3, 7, 2, 16), dtype)
    assert ours["blocks/sub0/ssm/h"] == ((n // 8, 3, 8, 16, 16), "float32")
    assert ours["blocks/sub0/ssm/conv"] == ((n // 8, 3, 3, 160), dtype)
    assert sum(k.endswith("/kv/k") for k in ours) == 1


def test_pad_cache_pads_only_the_attention_leaves_on_their_sequence_axis():
    """The reference's rule on values: the stacked ``kv`` leaves of sub3 are
    padded at the end of axis 2, the SSM conv windows and states (whose
    axes can equal the prompt length) are returned as they are."""
    jcfg, cfg = _configs("two_blocks")
    rng = np.random.default_rng(6)
    flat = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in
            jflatten(JM.make_cache(jcfg, 3, 3)).items()}
    assert flat["blocks/sub0/ssm/conv"].shape[2] == 3          # W-1 == prompt
    want = jflatten(JM.pad_cache(jcfg, nest_flat(
        {k: jnp.asarray(v) for k, v in flat.items()}), 3, 6))
    ours = flatten_tree(M.pad_cache(cfg, M.from_numpy_flat(flat, device="cpu",
                                                           requires_grad=False), 3, 6))
    assert list(ours) == list(want)
    for k, w in want.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(w), err_msg=k)
        if "/ssm/" in k:
            np.testing.assert_array_equal(ours[k].numpy(), flat[k], err_msg=k)
    assert ours["blocks/sub3/kv/v"].shape == (2, 3, 6, 2, 16)
    assert not ours["blocks/sub3/kv/v"][:, :, 3:].any()


# ---------------------------------------------------------------------------
# serving: prefill and decode
# ---------------------------------------------------------------------------

def _port_serve(cfg, params, tokens):
    cache, logits = M.prefill(cfg, params, {"tokens": _tokens(tokens[:, :S0])})
    prefill_cache = {k: v.numpy().copy() for k, v in flatten_tree(cache).items()}
    cache = M.pad_cache(cfg, cache, S0, S0 + GEN)
    steps = []
    for t in range(S0, S0 + GEN):
        lg, cache = M.decode_step(cfg, params, cache, _tokens(tokens[:, t:t + 1]), t)
        steps.append(lg.numpy())
    return logits.numpy(), prefill_cache, steps, {
        k: v.numpy() for k, v in flatten_tree(cache).items()}


@pytest.fixture(scope="module", params=list(LAYOUTS))
def served(request):
    """Both packages' serving runs of one layout on the same parameters and
    tokens, the MoE in its dense form; and the port's teacher-forced
    logits."""
    jcfg, cfg = _configs(request.param)
    jset_moe_impl("dense")
    set_moe_impl("dense")
    try:
        jparams, flat = _jax_params(jcfg)
        tokens = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (B, S0 + GEN)).astype(np.int32)
        jcache, jlogits = jax.jit(lambda p, t: JM.prefill(jcfg, p, {"tokens": t}))(
            jparams, jnp.asarray(tokens[:, :S0]))
        jprefill_cache = {k: np.asarray(v) for k, v in jflatten(jcache).items()}
        jcache = JM.pad_cache(jcfg, jcache, S0, S0 + GEN)
        jpadded = {k: np.asarray(v) for k, v in jflatten(jcache).items()}
        jstep = jax.jit(lambda p, c, t, pos: JM.decode_step(jcfg, p, c, t, pos))
        jsteps = []
        for t in range(S0, S0 + GEN):
            lg, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, t:t + 1]),
                               jnp.int32(t))
            jsteps.append(np.asarray(lg))
        jfinal = {k: np.asarray(v) for k, v in jflatten(jcache).items()}

        params = M.from_numpy_flat(flat, device="cpu")
        logits, prefill_cache, steps, final = _port_serve(cfg, params, tokens)
        with torch.no_grad():
            hidden, _ = M.forward_hidden(cfg, params, {"tokens": _tokens(tokens)})
            forced = torch.matmul(hidden, M._head_weight(cfg, params))[..., :cfg.vocab_size]
        from_jax = M.from_numpy_flat(jpadded, device="cpu", requires_grad=False)
        first_from_jax, _ = M.decode_step(cfg, params, from_jax,
                                          _tokens(tokens[:, S0:S0 + 1]), S0)
    finally:
        jset_moe_impl("gather")
        set_moe_impl("gather")
    return dict(cfg=cfg, jlogits=np.asarray(jlogits), jprefill_cache=jprefill_cache,
                jsteps=jsteps, jfinal=jfinal, logits=logits, prefill_cache=prefill_cache,
                steps=steps, final=final, forced=forced.numpy(),
                first_from_jax=first_from_jax.numpy())


def _assert_trees_close(ours: dict, want: dict, tol: float):
    assert list(ours) == list(want)
    for k, w in want.items():
        assert ours[k].shape == w.shape and str(ours[k].dtype) == str(w.dtype), k
        np.testing.assert_allclose(ours[k], w, atol=tol, rtol=tol, err_msg=k)


def test_prefill_logits_and_every_cache_leaf_match_jax(served):
    s = served
    assert s["logits"].shape == (B, s["cfg"].vocab_size)
    np.testing.assert_allclose(s["logits"], s["jlogits"], atol=TOL, rtol=TOL)
    _assert_trees_close(s["prefill_cache"], s["jprefill_cache"], TOL)
    kinds = {k.split("/")[-2] for k in s["prefill_cache"]}
    assert kinds == {"kv", "ssm"}
    # the SSD's final state and the conv window are real, not zeros
    assert np.abs(s["prefill_cache"]["blocks/sub0/ssm/h"]).max() > 0
    assert np.abs(s["prefill_cache"]["blocks/sub0/ssm/conv"]).max() > 0


def test_decode_steps_and_final_cache_match_jax(served):
    s = served
    for t, (ours, want) in enumerate(zip(s["steps"], s["jsteps"])):
        np.testing.assert_allclose(ours, want, atol=TOL, rtol=TOL,
                                   err_msg=f"decode step at pos {S0 + t}")
    _assert_trees_close(s["final"], s["jfinal"], TOL)
    # each decode step wrote the attention layer's cache at its position
    cfg = s["cfg"]
    k = s["final"][f"blocks/sub{(3 - cfg.scan_layers()[0]) % 8}/kv/k"]
    assert (np.abs(k[:, :, S0:S0 + GEN]).max(axis=(0, 1, 3, 4)) > 0).all()


def test_decode_from_the_references_prefill_cache(served):
    np.testing.assert_allclose(served["first_from_jax"], served["jsteps"][0],
                               atol=TOL, rtol=TOL)


def test_decode_matches_the_ports_teacher_forcing(served):
    s = served
    got = np.stack([s["logits"], *s["steps"]], axis=1)
    want = s["forced"][:, S0 - 1:S0 + GEN]
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) / scale < TF_TOL


# ---------------------------------------------------------------------------
# the trainer, the counts, the arch model and the CLIs
# ---------------------------------------------------------------------------

def _rounding(grads):
    """{key: mask} of the elements whose step-0 gradient is rounding: not 0
    (0 is an embedding row no token reaches, the same in every order of
    summation) and below ROUNDING, against gradients near 1e-2.  AdamW's
    first step moves such an element by about the learning rate in the
    direction of its rounding (m / (sqrt(v) + eps) with v near eps^2), so
    two orders of summation may step it in opposite directions."""
    return {k: (g != 0) & (np.abs(g) < ROUNDING) for k, g in grads.items()}


def test_trainer_static_and_rescaled_follow_the_jax_trainer(tmp_path):
    """jamba at smoke size (one block) from the JAX step-0 parameters: a
    static port trainer at R=4, and a port trainer through a host-lane
    shrink to 2 and a p2p expand to 4.  Every loss, aux and grad norm of
    both within the trajectory tolerance of the single-device JAX
    trainer's; the two port trainers' parameters at the end within it of
    each other, the reference's own static-vs-elastic check
    (``tests/helpers/elastic_trajectory.py``), and of the JAX trainer's
    everywhere but at the few elements whose step-0 gradient in the
    reference is rounding (``_rounding``).  Those elements are printed with
    their gradients; one of them, an expert's ``w_down`` weight with a
    gradient of about 1e-8, ends about 1e-4 from the reference's."""
    jt = JTrainer(jsmoke_config(ARCH), JJob(**JOB), jax.devices()[:1])
    jt.save_disk(JDiskStore(str(tmp_path)), "job")
    batch = {k: jnp.asarray(v) for k, v in jt.stream.global_batch_at(0).items()}
    g0 = jax.jit(jax.grad(lambda p, b: JM.loss_fn(jt.cfg, p, b)[0]))(jt.params, batch)
    g0 = {k: np.asarray(v) for k, v in jflatten(jax.device_get(g0)).items()}
    rounding = _rounding(g0)
    assert sum(int(m.sum()) for m in rounding.values()) < 64
    slots = local_slots(4)
    static = ElasticTrainer(smoke_config(ARCH), TrainJobConfig(**JOB), slots, device="cpu")
    pt = ElasticTrainer(smoke_config(ARCH), TrainJobConfig(**JOB), slots, device="cpu")
    for t in (static, pt):
        assert t.restore_disk(DiskCheckpointStore(str(tmp_path)), "job") == 0
    for i in range(6):
        if i == 2:
            assert pt.rescale(slots[2:], via_host=True).path == "host"
        if i == 4:
            assert pt.rescale(slots).path == "p2p"
        jm, sm, pm = jt.step(), static.step(), pt.step()
        for k in ("loss", "aux", "grad_norm"):
            assert abs(jm[k] - pm[k]) < TRAJ_TOL, (i, k, jm[k], pm[k])
            assert abs(jm[k] - sm[k]) < TRAJ_TOL, (i, k, jm[k], sm[k])
        assert pm["aux"] > 0
    assert [m["replicas"] for m in pt.metrics_log] == [4, 4, 2, 2, 4, 4]
    got, want = flatten_tree(pt.params), flatten_tree(static.params)
    assert list(got) == list(jflatten(jt.params))
    assert max(float((got[k] - want[k]).detach().abs().max()) for k in got) < TRAJ_TOL
    ref = {k: np.asarray(v) for k, v in jflatten(jax.device_get(jt.params)).items()}
    for name, trainer in (("rescaled", pt), ("static", static)):
        for k, v in flatten_tree(trainer.params).items():
            d = np.abs(v.detach().numpy() - ref[k])
            assert d[~rounding[k]].max(initial=0) < TRAJ_TOL, (name, k)
            if (d >= TRAJ_TOL).any():
                print(f"{name} {k}: beyond {TRAJ_TOL} by {d.max():.3e} where the "
                      f"reference's step-0 gradient is {g0[k][d >= TRAJ_TOL].tolist()}")


@pytest.mark.parametrize("layers,total,active", DEPTHS)
def test_param_counts_and_arch_model_at_full_width_equal_the_references(layers, total,
                                                                       active):
    cfg = get_config(ARCH).with_(num_layers=layers)
    jcfg = jget_config(ARCH).with_(num_layers=layers)
    assert cfg.scan_layers() == jcfg.scan_layers()
    assert M.param_count(cfg) == M.count_params(cfg) == JM.param_count(jcfg) == total
    assert M.count_active_params(cfg) == jcount_active(jcfg) == active
    ours = ppm.arch_model_from_config(cfg, seq_len=2048, global_batch=8)
    ref = jpm.arch_model_from_config(jcfg, seq_len=2048, global_batch=8)
    assert ours.flops_per_step == ref.flops_per_step
    assert ours.param_bytes == ref.param_bytes and ours.data_bytes == ref.data_bytes


def test_the_full_width_widths_are_jambas():
    """The widths new to the port: 128 SSM heads of head dim 64 and d_state
    16, GQA group 4 at head dim 128, 16 experts top-2 without shared
    experts on the odd layers, a dense SwiGLU of 14,336 on the even ones."""
    cfg = get_config(ARCH)
    shapes = M.param_shapes(cfg)
    assert shapes["decoder/blocks/sub0/mixer/in_proj"] == (4, 4096, 2 * 8192 + 2 * 16 + 128)
    assert shapes["decoder/blocks/sub0/mixer/a_log"] == (4, 128)
    assert shapes["decoder/blocks/sub3/mixer/wk"] == (4, 4096, 8, 128)
    assert shapes["decoder/blocks/sub3/mixer/wq"] == (4, 4096, 32, 128)
    assert shapes["decoder/blocks/sub1/ff/w_gate"] == (4, 16, 4096, 14336)
    assert shapes["decoder/blocks/sub0/ff/w_gate"] == (4, 4096, 14336)
    assert not any("shared" in k for k in shapes)
    assert [cfg.mixer_at(i) for i in range(8)] == [SSM] * 3 + [ATTN] + [SSM] * 4
    assert [cfg.ff_at(i) for i in range(4)] == [FF_SWIGLU, FF_MOE] * 2
    cache = M.make_cache(cfg.with_(num_layers=8), 2, 4, device="meta")
    flat = flatten_tree(cache)
    assert tuple(flat["blocks/sub3/kv/k"].shape) == (1, 2, 4, 8, 128)
    assert tuple(flat["blocks/sub0/ssm/h"].shape) == (1, 2, 128, 64, 16)
    assert flat["blocks/sub0/ssm/h"].dtype == torch.float32


def test_train_cli_rescales_checkpoints_and_restarts(tmp_path, capsys):
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--devices", "4",
            "--global-batch", "8", "--seq-len", "32", "--log-every", "1",
            "--checkpoint-dir", str(tmp_path)]
    t = train_cli.main(args + ["--steps", "6", "--rescale-at", "2:2",
                               "--rescale-at", "4:4", "--checkpoint-every", "3"])
    assert [r.path for r in t.rescale_log] == ["p2p", "p2p"]
    assert [m["replicas"] for m in t.metrics_log] == [4, 4, 2, 2, 4, 4]
    assert all(m["aux"] > 0 for m in t.metrics_log)
    t2 = train_cli.main(args + ["--steps", "8", "--restart"])
    assert "restarted from disk checkpoint at step 6" in capsys.readouterr().out
    assert [m["step"] for m in t2.metrics_log] == [7, 8]
    assert ops.launch_counts() == {k: 0 for k in ops.launch_counts()}


def test_serve_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
                           "--smoke", "--device", "cpu", "--batch", "3", "--prompt-len",
                           "16", "--gen", "5"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("[serve] prefill 3x16: ")
    assert lines[1].startswith("[serve] decoded 4 steps x 3 seqs: ")
    assert len(lines) == 6 and all(len(json.loads(line)) == 5 for line in lines[3:])


def test_chip_smoke_decode_bound_counts_the_routed_experts():
    """``chip_smoke.routed_experts`` reads each MoE layer call's counts of a
    decode step (the block's four MoE layers, B x top-2 assignments each),
    and ``decode_step_bytes`` counts the weights of the (layer, expert)
    pairs selected: each pair fewer is one expert's w_gate, w_up and
    w_down less, and none leaves every other weight and the cache."""
    sys.path.insert(0, REPO)
    import chip_smoke
    cfg = smoke_config(ARCH).with_(dtype="float32")
    m = cfg.moe
    params = M.init_params(cfg, 0, device="cpu")
    cache = M.make_cache(cfg, B, S0, device="cpu")
    toks = _tokens(np.random.default_rng(5).integers(0, cfg.vocab_size, (B, 1)))
    with chip_smoke.routed_experts() as routed:
        M.decode_step(cfg, params, cache, toks, 0)
    assert len(routed) == 4 and all(int(c.sum()) == B * m.experts_per_token for c in routed)
    chosen = sum(int((c > 0).sum()) for c in routed)
    assert 4 <= chosen <= 4 * min(m.num_experts, B * m.experts_per_token)
    per_expert = 3 * cfg.d_model * m.d_ff_expert * 4
    full = chip_smoke.decode_step_bytes(cfg, params, cache, B, 0, 4 * m.num_experts)
    assert full - chip_smoke.decode_step_bytes(cfg, params, cache, B, 0, chosen) == (
        (4 * m.num_experts - chosen) * per_expert)
    assert full - chip_smoke.decode_step_bytes(cfg, params, cache, B, 0, 0) == (
        4 * m.num_experts * per_expert)
    unused_rows = (params["embed"].shape[0] - B) * cfg.d_model * 4
    assert not cfg.tie_embeddings and full == sum(
        t.numel() * 4 for t in flatten_tree(params).values()) - unused_rows + sum(
        t.numel() * t.element_size() // t.shape[2] * 2 if "/kv/" in k else
        2 * t.numel() * t.element_size() for k, t in flatten_tree(cache).items())


def test_chip_smoke_hybrid_phase_rehearses_on_the_cpu(capsys):
    """``chip_smoke.py``'s phase 14 with the jamba smoke config on the CPU:
    the training job through both lanes (byte-exact restore, first loss
    near ln V, aux above 0 with the block's MoE layers, no launches),
    serving with its launch checks, and teacher forcing under the dense
    MoE."""
    sys.path.insert(0, REPO)
    import chip_smoke
    cfg = smoke_config(ARCH)
    train, serve = chip_smoke.hybrid_phase(
        "cpu", device="cpu", train_cfg=cfg, serve_cfg=cfg.with_(dtype="float32"), job=JOB,
        serve=dict(batch=2, prompt=16, gen=8), tf=dict(batch=1, prompt=8, gen=9))
    none = {"flash_attention": {}, "moe_gemm": {}, "pack": {}, "rmsnorm": {}, "ssd": {}}
    assert train == serve == none
    out = capsys.readouterr().out
    assert "[hybrid] restored_vs_snapshot_byte_exact=True" in out, out
    assert out.count("[hybrid] step=") == 6 and "first_loss=" in out
    assert "expected_ssd=0" in out and out.count("teacher_forcing_positions=9") == 1
