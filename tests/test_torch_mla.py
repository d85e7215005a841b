"""The port's multi-head latent attention and deepseek-v2 against the JAX
package on the CPU: the blocked-attention twin (forward and every gradient,
on the reference's own cases and at MLA's head dims with ``q_pos0`` and
``kv_len``), ``mla_forward`` in train mode with and without ``q_lora_rank``,
the deepseek smoke model's loss, aux and every gradient under both MoE
dispatches (and at depth 1, the dense prefix layer alone), the latent cache
(``make_cache``, ``pad_cache``), prefill and decode absorbed and
unabsorbed, decode from the reference's cache, teacher forcing, the
trainer through a host-lane shrink, the perf model, and both CLIs.

The reference runs as its own CPU tests run it: blocked attention in jnp,
``jax.jit`` on ``prefill`` and ``decode_step``, and the MoE in its dense form
wherever decode is compared (``tests/test_models.py``).  Parameters cross
with ``from_numpy_flat``.  Tolerances: fp32 forward 2e-5, gradients 1e-4,
blocked-attention gradients 5e-4, trajectories 5e-5, decode against teacher
forcing 2e-4."""
import dataclasses
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
from repro.kernels.blocked import blocked_attention as jblocked  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.moe import set_moe_impl as jset_moe_impl  # noqa: E402
from repro.models.transformer import set_mla_absorb as jset_mla_absorb  # noqa: E402
import repro_torch.core.perf_model as ppm  # noqa: E402
from repro_torch.checkpoint import DiskCheckpointStore, flatten_tree  # noqa: E402
from repro_torch.checkpoint.reshard import nest_flat  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core.elastic import (ElasticTrainer, TrainJobConfig,  # noqa: E402
                                      local_slots)
from repro_torch.data import make_stream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.blocked import blocked_attention  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.moe import set_moe_impl  # noqa: E402
from repro_torch.models.transformer import set_mla_absorb  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "deepseek-v2-236b"
TOL = 2e-5
GRAD_TOL = 1e-4
BLOCKED_GRAD_TOL = 5e-4
TRAJ_TOL = 5e-5
TF_TOL = 2e-4
B, S0, GEN = 2, 16, 4
JOB = dict(global_batch=8, seq_len=32, total_steps=12, seed=3)


def _np(t):
    return t.detach().numpy()


def _tokens(a):
    return torch.from_numpy(np.ascontiguousarray(a)).long()


def _configs(layers=None):
    jcfg = jsmoke_config(ARCH).with_(dtype="float32")
    cfg = smoke_config(ARCH).with_(dtype="float32")
    if layers is not None:
        jcfg, cfg = jcfg.with_(num_layers=layers), cfg.with_(num_layers=layers)
    return jcfg, cfg


def _jax_params(jcfg, seed=0):
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, {k: np.asarray(v) for k, v in jflatten(jparams).items()}


# ---------------------------------------------------------------------------
# the blocked twin
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, KV, hd, hdv, causal, q_pos0, kv_len, block_k): the
# reference's cases (tests/test_kernels.py), then MLA's 24/16 head dims
# (nope 16 + rope 8; v 16) at a later query position against a longer KV
BLOCKED_CASES = {
    "gqa": (2, 128, 128, 4, 2, 32, 32, True, 0, None, 32),
    "tail": (1, 100, 100, 6, 2, 16, 16, True, 0, None, 48),   # Sk off the block
    "mha": (2, 64, 64, 4, 4, 32, 32, True, 0, None, 64),
    "cross": (2, 32, 48, 4, 4, 16, 24, False, 0, None, 16),   # non-causal, hdv != hd
    "mla": (2, 16, 40, 4, 4, 24, 16, True, 24, None, 16),
    "mla_kv_len": (2, 12, 40, 4, 4, 24, 16, True, 20, 32, 16),
    "mla_decode": (2, 1, 40, 4, 4, 24, 16, True, 30, 31, 16),
}


@pytest.mark.parametrize("case", list(BLOCKED_CASES))
def test_blocked_twin_forward_and_every_gradient_match_jax(case):
    Bn, Sq, Sk, H, KV, hd, hdv, causal, q_pos0, kv_len, bk = BLOCKED_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((Bn, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((Bn, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((Bn, Sk, KV, hdv)).astype(np.float32)
    r = rng.standard_normal((Bn, Sq, H, hdv)).astype(np.float32)

    def jloss(*qkv):
        return jnp.sum(jblocked(*qkv, causal, None, q_pos0, kv_len, bk) * r)
    jout = jblocked(q, k, v, causal, None, q_pos0, kv_len, bk)
    jgrads = jax.grad(jloss, (0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = blocked_attention(tq, tk, tv, causal, None, q_pos0, kv_len, bk)
    assert out.shape == (Bn, Sq, H, hdv) and out.dtype == torch.float32
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(_np(out), np.asarray(jout), atol=TOL, rtol=TOL)
    for name, t, g in zip("qkv", (tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=BLOCKED_GRAD_TOL,
                                   rtol=BLOCKED_GRAD_TOL, err_msg=name)


def test_blocked_twin_matches_the_naive_softmax_with_a_distinct_v_dim():
    """The reference's non-causal cross-attention check, against the naive
    formula, and the twin's output in q's dtype."""
    rng = np.random.default_rng(9)
    q, k = (torch.from_numpy(rng.standard_normal((2, n, 4, 16)).astype(np.float32))
            for n in (32, 48))
    v = torch.from_numpy(rng.standard_normal((2, 48, 4, 24)).astype(np.float32))
    out = blocked_attention(q, k, v, False, None, 0, None, 16)
    p = torch.softmax(torch.einsum("bshd,bthd->bhst", q, k) * 16 ** -0.5, -1)
    torch.testing.assert_close(out, torch.einsum("bhst,bthv->bshv", p, v),
                               atol=TOL, rtol=TOL)
    half = blocked_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), False)
    assert half.dtype == torch.bfloat16 and half.shape == (2, 32, 4, 24)


# ---------------------------------------------------------------------------
# the MLA mixer in train mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_forward_train_and_every_gradient_match_jax(q_lora):
    jcfg, cfg = _configs()
    if not q_lora:
        jcfg = jcfg.with_(mla=dataclasses.replace(jcfg.mla, q_lora_rank=0))
        cfg = cfg.with_(mla=dataclasses.replace(cfg.mla, q_lora_rank=0))
    _, flat = _jax_params(jcfg)
    pre = "decoder/prefix/layer0/mixer/"
    jp = {k[len(pre):]: v for k, v in flat.items() if k.startswith(pre)}
    assert ("wq" in jp) != q_lora and ("wq_a" in jp) == q_lora
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    pos = np.arange(24)

    def jloss(p, x):
        y, _ = jattn.mla_forward(jcfg, p, x, positions=jnp.asarray(pos), mode="train")
        return jnp.sum(y * r), y
    (_, jy), (jgp, jgx) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x))
    p = M.from_numpy_flat(jp, device="cpu")
    tx = torch.from_numpy(x).requires_grad_()
    y, cache = attention.mla_forward(cfg, p, tx, positions=torch.from_numpy(pos))
    assert cache is None
    (y * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=GRAD_TOL, rtol=GRAD_TOL)
    for k, g in jgp.items():
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(g), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# the deepseek smoke model
# ---------------------------------------------------------------------------

def test_smoke_model_has_the_references_layout():
    jcfg, cfg = _configs()
    assert cfg.num_layers == 3 and cfg.scan_layers() == (1, 2) == jcfg.scan_layers()
    assert (cfg.mla.q_lora_rank, cfg.mla.kv_lora_rank, cfg.mla.qk_nope_head_dim,
            cfg.mla.qk_rope_head_dim, cfg.mla.v_head_dim, cfg.num_heads) == (32, 32, 16, 8, 16, 4)
    keys = M.param_shapes(cfg)
    assert keys["decoder/prefix/layer0/ff/w_gate"] == (64, 128)          # dense prefix
    assert keys["decoder/blocks/sub0/ff/w_gate"] == (2, 4, 64, 32)        # stacked MoE
    assert keys["decoder/blocks/sub0/ff/shared/w_gate"] == (2, 64, 64)    # 2 shared experts
    assert keys["decoder/blocks/sub0/mixer/wkv_b"] == (2, 32, 4, 32)
    assert M.param_shapes(cfg.with_(num_layers=1)).keys() == {
        k for k in keys if not k.startswith("decoder/blocks/")}


@pytest.mark.parametrize("layers,impl", [(None, "gather"), (None, "dense"), (1, "gather")])
def test_loss_aux_and_every_gradient_match_jax(layers, impl):
    jcfg, cfg = _configs(layers)
    jparams, flat = _jax_params(jcfg)
    assert list(flatten_tree(M.init_params(cfg, 0, device="cpu"))) == list(flat)
    batch = make_stream(cfg, seed=1, global_batch=4, seq_len=32).global_batch_at(0)
    batch["labels"][0, :5] = -1
    jset_moe_impl(impl)
    set_moe_impl(impl)
    try:
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        (jloss, jm), jgrads = jax.value_and_grad(
            lambda p: JM.loss_fn(jcfg, p, jbatch), has_aux=True)(jparams)
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
    assert (aux > 0) == (layers is None)     # depth 1: the dense layer only
    jg = {k: np.asarray(v) for k, v in jflatten(jgrads).items()}
    tg = flatten_tree(params)
    assert list(tg) == list(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k].grad.numpy(), jg[k], atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=k)


def test_moe_layer_at_deepseeks_layout_matches_jax():
    """The MoE layer at deepseek's own layout (160 experts, top-6, 2 shared,
    capacity 1.25) at a narrow width: output, aux and the gradients of x and
    every expert leaf, through the gather dispatch (tokens drop: 64 tokens
    a sequence give a capacity of 4 slots an expert)."""
    from repro.models.moe import moe_forward as jmoe_forward
    from repro_torch.models.moe import moe_forward
    jcfg = _configs()[0].with_(d_model=32, moe=dataclasses.replace(
        jget_config(ARCH).moe, d_ff_expert=16))
    cfg = _configs()[1].with_(d_model=32, moe=dataclasses.replace(
        get_config(ARCH).moe, d_ff_expert=16))
    assert (cfg.moe.num_experts, cfg.moe.experts_per_token, cfg.moe.num_shared_experts,
            cfg.moe.capacity_factor) == (160, 6, 2, 1.25)
    _, flat = _jax_params(jcfg)
    pre = "decoder/blocks/sub0/ff/"
    jp = {k[len(pre):]: v[0] for k, v in flat.items() if k.startswith(pre)}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 64, 32)).astype(np.float32)
    r = rng.standard_normal((2, 64, 32)).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe_forward(jcfg, p, x)
        return jnp.sum(y * r) + aux, (y, aux)
    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        nest_flat({k: jnp.asarray(v) for k, v in jp.items()}), jnp.asarray(x))
    p = M.from_numpy_flat(jp, device="cpu")
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe_forward(cfg, p, tx)
    ((y * torch.from_numpy(r)).sum() + aux).backward()
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=GRAD_TOL, rtol=GRAD_TOL)
    tg = flatten_tree(p)
    for k, g in jflatten(jgp).items():
        np.testing.assert_allclose(tg[k].grad.numpy(), np.asarray(g), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# the latent cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", [None, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_and_pad_cache_match_the_references_keys_shapes_and_dtypes(layers, dtype):
    jcfg, cfg = (c.with_(dtype=dtype) for c in _configs(layers))
    for prompt, window in ((5, 5), (5, 9), (3, 7)):
        ours = M.pad_cache(cfg, M.make_cache(cfg, 3, prompt, device="cpu"), prompt, window)
        want = JM.pad_cache(jcfg, JM.make_cache(jcfg, 3, prompt), prompt, window)
        ours = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in flatten_tree(ours).items()}
        want = {k: (v.shape, str(v.dtype)) for k, v in jflatten(want).items()}
        assert ours == want and list(ours) == list(want)
    assert ours["prefix/layer0/kv/ckv"][0] == (3, 7, 32)
    assert ours["prefix/layer0/kv/krope"][0] == (3, 7, 8)
    if layers is None:
        assert ours["blocks/sub0/kv/ckv"][0] == (2, 3, 7, 32)


def test_pad_cache_pads_the_sequence_axis_of_prefix_and_stacked_leaves():
    """The reference's rule on values, not only shapes: a stacked (L,B,S,r)
    leaf is padded on axis 2, a prefix (B,S,r) leaf on axis 1, at the end,
    and a stacked leaf whose batch equals the prompt length is not padded on
    its batch axis."""
    jcfg, cfg = _configs()
    rng = np.random.default_rng(6)
    flat = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in
            jflatten(JM.make_cache(jcfg, 4, 4)).items()}
    want = jflatten(JM.pad_cache(jcfg, nest_flat(
        {k: jnp.asarray(v) for k, v in flat.items()}), 4, 6))
    ours = flatten_tree(M.pad_cache(cfg, M.from_numpy_flat(flat, device="cpu",
                                                           requires_grad=False), 4, 6))
    for k, w in want.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(w), err_msg=k)
    assert ours["blocks/sub0/kv/ckv"].shape == (2, 4, 6, 32)
    assert ours["prefix/layer0/kv/ckv"].shape == (4, 6, 32)


# ---------------------------------------------------------------------------
# serving: prefill and decode, absorbed and unabsorbed
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


SERVED = {"absorbed": (None, True), "unabsorbed": (None, False),
          "depth1_absorbed": (1, True)}


@pytest.fixture(scope="module", params=list(SERVED))
def served(request):
    """Both packages' serving runs of the deepseek smoke model on the same
    parameters and tokens, with decode absorbed or not in both, the MoE in
    its dense form; and the port's teacher-forced logits."""
    layers, absorb = SERVED[request.param]
    jcfg, cfg = _configs(layers)
    jset_moe_impl("dense")
    set_moe_impl("dense")
    jset_mla_absorb("decode", absorb)
    set_mla_absorb("decode", absorb)
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
        jset_mla_absorb("decode", True)
        set_mla_absorb("decode", True)
    return dict(cfg=cfg, jlogits=np.asarray(jlogits), jprefill_cache=jprefill_cache,
                jsteps=jsteps, jfinal=jfinal, logits=logits, prefill_cache=prefill_cache,
                steps=steps, final=final, forced=forced.numpy(),
                first_from_jax=first_from_jax.numpy())


def _assert_trees_close(ours: dict, want: dict, tol: float):
    assert list(ours) == list(want)
    for k, w in want.items():
        assert ours[k].shape == w.shape and str(ours[k].dtype) == str(w.dtype), k
        np.testing.assert_allclose(ours[k], w, atol=tol, rtol=tol, err_msg=k)


def test_prefill_logits_and_the_latent_cache_match_jax(served):
    s = served
    assert s["logits"].shape == (B, s["cfg"].vocab_size)
    np.testing.assert_allclose(s["logits"], s["jlogits"], atol=TOL, rtol=TOL)
    _assert_trees_close(s["prefill_cache"], s["jprefill_cache"], TOL)
    assert set(s["prefill_cache"]) >= {"prefix/layer0/kv/ckv", "prefix/layer0/kv/krope"}


def test_decode_steps_and_final_cache_match_jax(served):
    s = served
    for t, (ours, want) in enumerate(zip(s["steps"], s["jsteps"])):
        np.testing.assert_allclose(ours, want, atol=TOL, rtol=TOL,
                                   err_msg=f"decode step at pos {S0 + t}")
    _assert_trees_close(s["final"], s["jfinal"], TOL)


def test_decode_from_the_references_prefill_cache(served):
    np.testing.assert_allclose(served["first_from_jax"], served["jsteps"][0],
                               atol=TOL, rtol=TOL)


def test_decode_matches_the_ports_teacher_forcing(served):
    s = served
    got = np.stack([s["logits"], *s["steps"]], axis=1)
    want = s["forced"][:, S0 - 1:S0 + GEN]
    assert float(np.abs(got - want).max()) < TF_TOL


def test_absorbed_and_unabsorbed_decode_agree_from_one_cache():
    """One decode step from the same padded cache, through both forms: the
    absorbed one never expands per-head K and V, yet gives the same logits
    and writes the same latent entries (the first layer's bit for bit; a
    later layer's from an input that differs by rounding)."""
    _, cfg = _configs()
    params = M.init_params(cfg, 4, device="cpu")
    tokens = _tokens(np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S0 + 1)))
    cache, _ = M.prefill(cfg, params, {"tokens": tokens[:, :S0]})
    cache = flatten_tree(M.pad_cache(cfg, cache, S0, S0 + 1))
    out = {}
    for absorb in (True, False):
        set_mla_absorb("decode", absorb)
        try:
            c = {k: v.clone() for k, v in cache.items()}
            lg, c = M.decode_step(cfg, params, nest_flat(c), tokens[:, S0:], S0)
            out[absorb] = lg, flatten_tree(c)
        finally:
            set_mla_absorb("decode", True)
    torch.testing.assert_close(out[True][0], out[False][0], atol=TOL, rtol=TOL)
    for k in cache:
        exact = k.startswith("prefix/")
        torch.testing.assert_close(out[True][1][k], out[False][1][k],
                                   atol=0 if exact else TOL, rtol=0 if exact else TOL)
    with pytest.raises(ValueError):
        set_mla_absorb("serve", True)


# ---------------------------------------------------------------------------
# the trainer, the perf model and the CLIs
# ---------------------------------------------------------------------------

def test_trainer_follows_the_jax_trainer_through_both_lanes(tmp_path):
    """deepseek at smoke size from the JAX step-0 parameters: R=4, a
    host-lane shrink to 2, a p2p expand to 4; every loss, aux and grad norm
    within the trajectory tolerance of the single-device JAX trainer's, and
    the parameters at the end."""
    jt = JTrainer(jsmoke_config(ARCH), JJob(**JOB), jax.devices()[:1])
    jt.save_disk(JDiskStore(str(tmp_path)), "job")
    slots = local_slots(4)
    pt = ElasticTrainer(smoke_config(ARCH), TrainJobConfig(**JOB), slots, device="cpu")
    assert pt.restore_disk(DiskCheckpointStore(str(tmp_path)), "job") == 0
    for i in range(6):
        if i == 2:
            assert pt.rescale(slots[2:], via_host=True).path == "host"
        if i == 4:
            assert pt.rescale(slots).path == "p2p"
        jm, pm = jt.step(), pt.step()
        for k in ("loss", "aux", "grad_norm"):
            assert abs(jm[k] - pm[k]) < TRAJ_TOL, (i, k, jm[k], pm[k])
        assert pm["aux"] > 0
    assert [m["replicas"] for m in pt.metrics_log] == [4, 4, 2, 2, 4, 4]
    want = jflatten(jax.device_get(jt.params))
    got = {k: v.detach().numpy() for k, v in flatten_tree(pt.params).items()}
    assert list(got) == list(want)
    assert max(float(np.abs(got[k] - np.asarray(want[k])).max()) for k in got) < TRAJ_TOL


@pytest.mark.parametrize("layers", [None, 1, 4])
def test_param_counts_and_arch_model_equal_the_references(layers):
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    if layers is not None:
        cfg, jcfg = cfg.with_(num_layers=layers), jcfg.with_(num_layers=layers)
    assert M.param_count(cfg) == M.count_params(cfg) == JM.param_count(jcfg)
    assert M.count_active_params(cfg) == jcount_active(jcfg)
    ours = ppm.arch_model_from_config(cfg, seq_len=2048, global_batch=8)
    ref = jpm.arch_model_from_config(jcfg, seq_len=2048, global_batch=8)
    assert ours.flops_per_step == ref.flops_per_step
    assert ours.param_bytes == ref.param_bytes and ours.data_bytes == ref.data_bytes


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


def test_chip_smoke_mla_phase_rehearses_on_the_cpu(capsys):
    """``chip_smoke.py``'s phase 13 with the deepseek smoke config on the
    CPU: the training job through both lanes (byte-exact restore, first
    loss near ln V, no launches), serving with the absorbed-vs-unabsorbed
    check, and teacher forcing under the dense MoE."""
    sys.path.insert(0, REPO)
    import chip_smoke
    cfg = smoke_config(ARCH)
    train, serve = chip_smoke.mla_phase(
        "cpu", device="cpu", train_cfg=cfg, serve_cfg=cfg.with_(dtype="float32"), job=JOB,
        serve=dict(batch=2, prompt=16, gen=8), tf=dict(batch=1, prompt=8, gen=5))
    none = {"flash_attention": {}, "moe_gemm": {}, "pack": {}, "rmsnorm": {}, "ssd": {}}
    assert train == serve == none
    out = capsys.readouterr().out
    assert "restored_vs_snapshot_byte_exact=True" in out, out
    assert out.count("[mla] step=") == 6 and "first_loss=" in out
    assert "absorbed_vs_unabsorbed_pos=16" in out and out.count("teacher_forcing_positions=5") == 1
