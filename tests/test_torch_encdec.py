"""The port's encoder-decoder layout (seamless-m4t-large-v2) against the JAX
package on the CPU: the parameter tree, the ``EncDecStream`` frames and
shards, the encoder alone, cross attention (no RoPE on q) and bidirectional
self-attention, the smoke model's loss and every gradient (the encoder's
included), prefill logits and every cache leaf (the cross cache included),
``pad_cache`` leaving the cross cache alone, decode steps, decode from the
reference's cache, teacher forcing, the trainer from a JAX step-0
checkpoint through both lanes, a bf16 trainer's encoder input, both CLIs,
and ``chip_smoke.py``'s phase 15 and its repaired helpers at smoke size.

The reference runs as its own CPU tests run it: blocked attention in jnp,
``jax.jit`` on ``prefill`` and ``decode_step``.  Parameters cross with
``from_numpy_flat``.  Tolerances: forward, prefill, cache and loss 2e-5;
gradients 1e-4, or 5e-4 for leaves behind the blocked twin; trajectories
5e-5; decode against teacher forcing 2e-4 x max(1, max |logit|)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import DiskCheckpointStore as JDiskStore  # noqa: E402
from repro.checkpoint.reshard import flatten_tree as jflatten  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.core.elastic import ElasticTrainer as JTrainer  # noqa: E402
from repro.core.elastic import TrainJobConfig as JJob  # noqa: E402
from repro.data import make_stream as jmake_stream  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.checkpoint import DiskCheckpointStore, flatten_tree  # noqa: E402
from repro_torch.checkpoint.reshard import nest_flat  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core.elastic import (ElasticTrainer, TrainJobConfig,  # noqa: E402
                                      local_slots)
from repro_torch.data import EncDecStream, make_stream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

ARCH = "seamless-m4t-large-v2"
TOL = 2e-5
GRAD_TOL = 1e-4
BLOCKED_GRAD_TOL = 5e-4
TRAJ_TOL = 5e-5
TF_TOL = 2e-4
B, S0, GEN, ENC = 2, 16, 4, 12
JOB = dict(global_batch=8, seq_len=32, total_steps=12, seed=3)
NO_LAUNCHES = {"flash_attention": {}, "moe_gemm": {}, "pack": {}, "rmsnorm": {}, "ssd": {}}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The file's trainers run many small ops: with the intra-op pool of
    every parallel pytest worker on every core, their threads spin against
    each other and a 2 s test takes minutes.  One thread for this module,
    restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().numpy()


def _tokens(a):
    return torch.from_numpy(np.ascontiguousarray(a)).long()


def _configs():
    return (jsmoke_config(ARCH).with_(dtype="float32"),
            smoke_config(ARCH).with_(dtype="float32"))


def _jax_params(jcfg, seed=0):
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, {k: np.asarray(v) for k, v in jflatten(jparams).items()}


def _port_batch(batch_np):
    """Tokens and labels as long, the frames as float32."""
    return {k: torch.from_numpy(v) if v.dtype.kind == "f" else torch.from_numpy(v).long()
            for k, v in batch_np.items()}


def _behind_blocked(key):
    """A leaf whose gradient comes through the blocked twin's backward: the
    encoder's (its attention) and every cross block's."""
    return key.startswith("encoder/") or "/cross" in key


# ---------------------------------------------------------------------------
# parameters and the data stream
# ---------------------------------------------------------------------------

def test_param_keys_shapes_and_counts_equal_the_references():
    jcfg, cfg = _configs()
    _, flat = _jax_params(jcfg)
    assert M.param_shapes(cfg) == {k: v.shape for k, v in flat.items()}
    assert list(flatten_tree(M.init_params(cfg, 0, device="cpu"))) == list(flat)
    assert cfg.enc_layers == 2 and cfg.num_layers == 2 and cfg.scan_layers() == (0, 2)
    shapes = M.param_shapes(get_config(ARCH))
    parts = {"encoder": 0, "decoder": 0, "embed": 0, "final_norm": 0}
    for k, shape in shapes.items():
        parts[k.split("/")[0]] += int(np.prod(shape))
    assert parts == {"encoder": 503_366_656, "decoder": 604_053_504,
                     "embed": 256_256 * 1024, "final_norm": 1024}
    assert sum(parts.values()) == M.param_count(get_config(ARCH)) == 1_369_827_328
    assert shapes["decoder/blocks/sub0/cross/wk"] == (24, 1024, 16, 64)
    assert shapes["encoder/blocks/ff/w_up"] == (24, 1024, 8192)
    assert "lm_head" not in shapes


@pytest.mark.parametrize("step,enc_len", [(0, 0), (3, 24), (11, 8)])
def test_encdec_stream_batches_and_shards_are_bit_identical(step, enc_len):
    jcfg, cfg = _configs()
    ours = make_stream(cfg, seed=3, global_batch=8, seq_len=16, enc_len=enc_len)
    ref = jmake_stream(jcfg, seed=3, global_batch=8, seq_len=16, enc_len=enc_len)
    assert isinstance(ours, EncDecStream)
    a, b = ours.global_batch_at(step), ref.global_batch_at(step)
    assert list(a) == list(b) == ["tokens", "labels", "enc_embeds"]
    assert a["enc_embeds"].shape == (8, enc_len or 16, cfg.d_model)
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    for r in (1, 2, 4):
        for i in range(r):
            sa, sb = ours.shard_at(step, i, r), ref.shard_at(step, i, r)
            for k in sb:
                assert sa[k].tobytes() == sb[k].tobytes(), (r, i, k)
    assert type(make_stream(smoke_config("yi-6b"), seed=3, global_batch=8,
                            seq_len=16)).__name__ == "TokenStream"


# ---------------------------------------------------------------------------
# the pieces: encoder, cross attention, bidirectional attention
# ---------------------------------------------------------------------------

def test_encoder_alone_and_every_gradient_match_jax():
    jcfg, cfg = _configs()
    _, flat = _jax_params(jcfg)
    eflat = {k[len("encoder/"):]: v for k, v in flat.items() if k.startswith("encoder/")}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, ENC, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((B, ENC, cfg.d_model)).astype(np.float32)
    pos = np.arange(ENC)

    def jloss(p, x):
        y = jtfm.encoder(jcfg, p, x, positions=jnp.asarray(pos), mode="train")
        return jnp.sum(y * r), y
    (_, jy), (jgp, jgx) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        nest_flat({k: jnp.asarray(v) for k, v in eflat.items()}), jnp.asarray(x))
    p = M.from_numpy_flat(eflat, device="cpu")
    tx = torch.from_numpy(x).requires_grad_()
    y = transformer.encoder(cfg, p, tx, positions=torch.from_numpy(pos))
    (y * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=BLOCKED_GRAD_TOL,
                               rtol=BLOCKED_GRAD_TOL)
    tg = flatten_tree(p)
    for k, g in jflatten(jgp).items():
        np.testing.assert_allclose(tg[k].grad.numpy(), np.asarray(g), atol=BLOCKED_GRAD_TOL,
                                   rtol=BLOCKED_GRAD_TOL, err_msg=k)
    with torch.inference_mode():      # prefill mode: the same layers, no checkpoint
        y2 = transformer.encoder(cfg, p, torch.from_numpy(x),
                                 positions=torch.from_numpy(pos), mode="prefill")
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)


# (mode, kv_override, causal, Sq, pos): cross attention in train and decode
# mode, bidirectional self-attention (the encoder's), and an override with
# causal=True (q rotated, as the reference allows)
ATTN_CASES = {
    "cross_train": ("train", True, False, 10, None),
    "cross_decode": ("decode", True, False, 1, 7),
    "bidirectional": ("train", False, False, 10, None),
    "cross_causal": ("train", True, True, 10, None),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_forward_and_every_gradient_match_jax(case):
    mode, override, causal, Sq, pos = ATTN_CASES[case]
    jcfg, cfg = _configs()
    _, flat = _jax_params(jcfg)
    pre = "decoder/blocks/sub0/cross/" if override else "encoder/blocks/mixer/"
    jp = {k[len(pre):]: v[0] for k, v in flat.items() if k.startswith(pre)}
    rng = np.random.default_rng(len(case))
    H, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    x = rng.standard_normal((B, Sq, cfg.d_model)).astype(np.float32)
    k = rng.standard_normal((B, ENC, H, hd)).astype(np.float32)
    v = rng.standard_normal((B, ENC, H, hd)).astype(np.float32)
    r = rng.standard_normal((B, Sq, cfg.d_model)).astype(np.float32)
    positions = np.arange(Sq) + (pos or 0)

    def jloss(p, x, k, v):
        y, _ = jattn.attn_forward(jcfg, p, x, positions=jnp.asarray(positions), mode=mode,
                                  pos=None if pos is None else jnp.int32(pos),
                                  kv_override=(k, v) if override else None, causal=causal)
        return jnp.sum(y * r), y
    (_, jy), jgrads = jax.value_and_grad(jloss, (0, 1, 2, 3), has_aux=True)(
        {n: jnp.asarray(a) for n, a in jp.items()}, jnp.asarray(x), jnp.asarray(k),
        jnp.asarray(v))
    p = M.from_numpy_flat(jp, device="cpu")
    tx, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (x, k, v))
    y, cache = attention.attn_forward(cfg, p, tx, positions=torch.from_numpy(positions),
                                      mode=mode, pos=pos,
                                      kv_override=(tk, tv) if override else None,
                                      causal=causal)
    assert cache is None
    (y * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=TOL, rtol=TOL)
    jgp, jgx, jgk, jgv = jgrads
    if override:            # k, v taken as given: the projections take no gradient
        assert p["wk"].grad is None and p["wv"].grad is None
        assert not np.asarray(jgp.pop("wk")).any() and not np.asarray(jgp.pop("wv")).any()
    got = {"x": tx.grad, **({"k": tk.grad, "v": tv.grad} if override else {}),
           **{n: p[n].grad for n in jgp}}
    want = {"x": jgx, **({"k": jgk, "v": jgv} if override else {}), **jgp}
    for n, g in want.items():
        np.testing.assert_allclose(got[n].numpy(), np.asarray(g), atol=BLOCKED_GRAD_TOL,
                                   rtol=BLOCKED_GRAD_TOL, err_msg=n)


@pytest.mark.parametrize("mode", ["train", "decode"])
def test_cross_attention_puts_no_rope_on_q(mode):
    """Shifting the decoder positions leaves cross attention's output as it
    is (neither q nor the given k is rotated), and with ``causal=True`` it
    does not (q is)."""
    _, cfg = _configs()
    p = M.init_params(cfg, 1, device="cpu")["decoder"]["blocks"]["sub0"]["cross"]
    p = {n: t.detach()[0] for n, t in p.items()}
    g = torch.Generator().manual_seed(4)
    Sq = 1 if mode == "decode" else 6
    x = torch.randn((B, Sq, cfg.d_model), generator=g)
    kv = tuple(torch.randn((B, ENC, cfg.num_kv_heads, cfg.resolved_head_dim), generator=g)
               for _ in range(2))

    def run(shift, causal):
        y, _ = attention.attn_forward(cfg, p, x, positions=torch.arange(Sq) + shift,
                                      mode=mode, pos=shift, kv_override=kv, causal=causal)
        return y
    torch.testing.assert_close(run(0, False), run(5, False), atol=0, rtol=0)
    assert not torch.allclose(run(0, True), run(5, True), atol=1e-3)


# ---------------------------------------------------------------------------
# the smoke model: loss and every gradient
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained():
    """The reference's and the port's loss, metrics and gradients of one
    batch of the smoke model, from the same parameters."""
    jcfg, cfg = _configs()
    jparams, flat = _jax_params(jcfg)
    batch = make_stream(cfg, seed=1, global_batch=4, seq_len=32, enc_len=24).global_batch_at(0)
    batch["labels"][0, :5] = -1
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jbatch), has_aux=True)(jparams)
    params = M.from_numpy_flat(flat, device="cpu")
    loss, m = M.loss_fn(cfg, params, _port_batch(batch))
    loss.backward()
    return dict(jloss=float(jloss), jm=jm, loss=float(loss.detach()), m=m,
                jgrads={k: np.asarray(v) for k, v in jflatten(jgrads).items()},
                grads={k: t.grad.numpy() for k, t in flatten_tree(params).items()})


def test_loss_matches_jax(trained):
    t = trained
    np.testing.assert_allclose(t["loss"], t["jloss"], atol=TOL, rtol=TOL)
    assert float(t["m"]["aux"]) == float(t["jm"]["aux"]) == 0.0
    assert float(t["m"]["tokens"]) == float(t["jm"]["tokens"]) == 4 * 32 - 5


def test_every_gradient_matches_jax_the_encoders_included(trained):
    jg, tg = trained["jgrads"], trained["grads"]
    assert list(tg) == list(jg)
    assert sum(k.startswith("encoder/") for k in tg) == 9
    for k in jg:
        tol = BLOCKED_GRAD_TOL if _behind_blocked(k) else GRAD_TOL
        np.testing.assert_allclose(tg[k], jg[k], atol=tol, rtol=tol, err_msg=k)
        if k.startswith("encoder/blocks/") and not k.endswith("norm"):
            assert np.abs(tg[k]).max() > 0, k       # the encoder is trained


# ---------------------------------------------------------------------------
# serving: the cross cache, prefill, decode, teacher forcing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pad_cache_pads_self_attention_and_leaves_the_cross_cache_untouched(dtype):
    """Values, not only shapes: the reference's rule on random entries; the
    cross leaves come back as the very tensors given."""
    jcfg, cfg = (c.with_(dtype=dtype) for c in _configs())
    rng = np.random.default_rng(6)
    jflat = jflatten(JM.make_cache(jcfg, B, 5, enc_len=ENC))
    flat = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in jflat.items()}
    want = jflatten(JM.pad_cache(jcfg, nest_flat(
        {k: jnp.asarray(v) for k, v in flat.items()}), 5, 9))
    given = M.from_numpy_flat(flat, device="cpu", requires_grad=False)
    ours = flatten_tree(M.pad_cache(cfg, given, 5, 9))
    for k, w in want.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(w), err_msg=k)
    assert ours["blocks/sub0/kv/k"].shape == (2, B, 9, 4, 16)
    for k in ("blocks/sub0/cross/ck", "blocks/sub0/cross/cv"):
        assert ours[k] is flatten_tree(given)[k] and ours[k].shape == (2, B, ENC, 4, 16)


def _port_serve(cfg, params, tokens, frames):
    cache, logits = M.prefill(cfg, params, {"tokens": _tokens(tokens[:, :S0]),
                                            "enc_embeds": torch.from_numpy(frames)})
    prefill_cache = {k: v.numpy().copy() for k, v in flatten_tree(cache).items()}
    cache = M.pad_cache(cfg, cache, S0, S0 + GEN)
    steps = []
    for t in range(S0, S0 + GEN):
        lg, cache = M.decode_step(cfg, params, cache, _tokens(tokens[:, t:t + 1]), t)
        steps.append(lg.numpy())
    return logits.numpy(), prefill_cache, steps, {
        k: v.numpy() for k, v in flatten_tree(cache).items()}


@pytest.fixture(scope="module")
def served():
    """Both packages' serving runs of the smoke model on the same parameters,
    tokens and frames (ENC of them, fewer than the prompt's tokens), and the
    port's teacher-forced logits."""
    jcfg, cfg = _configs()
    jparams, flat = _jax_params(jcfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S0 + GEN)).astype(np.int32)
    frames = rng.standard_normal((B, ENC, cfg.d_model)).astype(np.float32)
    jcache, jlogits = jax.jit(lambda p, t, e: JM.prefill(
        jcfg, p, {"tokens": t, "enc_embeds": e}))(jparams, jnp.asarray(tokens[:, :S0]),
                                                   jnp.asarray(frames))
    jprefill_cache = {k: np.asarray(v) for k, v in jflatten(jcache).items()}
    jcache = JM.pad_cache(jcfg, jcache, S0, S0 + GEN)
    jpadded = {k: np.asarray(v) for k, v in jflatten(jcache).items()}
    jstep = jax.jit(lambda p, c, t, pos: JM.decode_step(jcfg, p, c, t, pos))
    jsteps = []
    for t in range(S0, S0 + GEN):
        lg, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, t:t + 1]), jnp.int32(t))
        jsteps.append(np.asarray(lg))
    jfinal = {k: np.asarray(v) for k, v in jflatten(jcache).items()}

    params = M.from_numpy_flat(flat, device="cpu")
    logits, prefill_cache, steps, final = _port_serve(cfg, params, tokens, frames)
    with torch.no_grad():
        hidden, _ = M.forward_hidden(cfg, params, {"tokens": _tokens(tokens),
                                                   "enc_embeds": torch.from_numpy(frames)})
        forced = torch.matmul(hidden, M._head_weight(cfg, params))[..., :cfg.vocab_size]
    from_jax = M.from_numpy_flat(jpadded, device="cpu", requires_grad=False)
    first_from_jax, _ = M.decode_step(cfg, params, from_jax, _tokens(tokens[:, S0:S0 + 1]),
                                      S0)
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
    assert s["prefill_cache"]["blocks/sub0/cross/ck"].shape == (2, B, ENC, 4, 16)
    assert np.abs(s["prefill_cache"]["blocks/sub0/cross/cv"]).min() >= 0    # written
    assert np.abs(s["prefill_cache"]["blocks/sub0/cross/cv"]).max() > 0


def test_decode_steps_and_final_cache_match_jax(served):
    s = served
    for t, (ours, want) in enumerate(zip(s["steps"], s["jsteps"])):
        np.testing.assert_allclose(ours, want, atol=TOL, rtol=TOL,
                                   err_msg=f"decode step at pos {S0 + t}")
    _assert_trees_close(s["final"], s["jfinal"], TOL)
    for k in ("blocks/sub0/cross/ck", "blocks/sub0/cross/cv"):   # decode reads it only
        np.testing.assert_array_equal(s["final"][k], s["prefill_cache"][k])


def test_decode_from_the_references_prefill_cache(served):
    np.testing.assert_allclose(served["first_from_jax"], served["jsteps"][0],
                               atol=TOL, rtol=TOL)


def test_decode_matches_the_ports_teacher_forcing(served):
    s = served
    got = np.stack([s["logits"], *s["steps"]], axis=1)
    want = s["forced"][:, S0 - 1:S0 + GEN]
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) < TF_TOL * scale


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_trainer_follows_the_jax_trainer_through_both_lanes(tmp_path):
    """From the JAX step-0 parameters: R=4, a host-lane shrink to 2, a p2p
    expand to 4; every loss and grad norm within the trajectory tolerance
    of the single-device JAX trainer's, and the parameters at the end.  The
    frames reach the model as float32 (cast to long, they would be
    truncated to integers without an error)."""
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
        for k in ("loss", "grad_norm"):
            assert abs(jm[k] - pm[k]) < TRAJ_TOL, (i, k, jm[k], pm[k])
        assert pm["aux"] == 0.0
    assert [m["replicas"] for m in pt.metrics_log] == [4, 4, 2, 2, 4, 4]
    want = jflatten(jax.device_get(jt.params))
    got = {k: v.detach().numpy() for k, v in flatten_tree(pt.params).items()}
    assert list(got) == list(want)
    assert max(float(np.abs(got[k] - np.asarray(want[k])).max()) for k in got) < TRAJ_TOL


def test_a_bf16_trainers_encoder_input_reaches_the_first_layer_in_bfloat16(monkeypatch):
    seen = []
    layer = transformer.encoder_layer

    def spy(cfg, p, x, positions):
        seen.append(x.detach().clone())
        return layer(cfg, p, x, positions)
    monkeypatch.setattr(transformer, "encoder_layer", spy)
    t = ElasticTrainer(smoke_config(ARCH), TrainJobConfig(**JOB, dtype="bfloat16"),
                       local_slots(2), device="cpu")
    assert t.params["embed"].dtype == torch.bfloat16
    m = t.step()
    assert np.isfinite(m["loss"])
    # each shard's forward and recompute run both encoder layers
    assert len(seen) == 2 * 2 * 2 and all(x.dtype == torch.bfloat16 for x in seen)
    frames = t.stream.global_batch_at(0)["enc_embeds"]
    lo, hi = t.stream.shard_bounds(0, 2)
    torch.testing.assert_close(seen[0], torch.from_numpy(frames[lo:hi]).bfloat16(),
                               atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_train_cli_rescales_checkpoints_and_restarts(tmp_path, capsys):
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--devices", "4",
            "--global-batch", "8", "--seq-len", "32", "--log-every", "1",
            "--checkpoint-dir", str(tmp_path)]
    t = train_cli.main(args + ["--steps", "6", "--rescale-at", "2:2",
                               "--rescale-at", "4:4", "--checkpoint-every", "3"])
    assert [r.path for r in t.rescale_log] == ["p2p", "p2p"]
    assert [m["replicas"] for m in t.metrics_log] == [4, 4, 2, 2, 4, 4]
    assert all(np.isfinite(m["loss"]) for m in t.metrics_log)
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
    assert len(lines) == 6


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 15 and its repaired helpers
# ---------------------------------------------------------------------------

def _meta_model(cfg, batch, window):
    """Parameters and a cache of ``cfg`` at any size, as meta tensors: the
    byte bound reads only shapes and dtypes."""
    params = nest_flat({k: torch.empty(s, device="meta")
                        for k, s in M.param_shapes(cfg).items()})
    return params, M.make_cache(cfg, batch, window, enc_len=window - 64, device="meta")


def test_decode_bytes_count_no_encoder_weight_no_cross_projection_and_the_cross_cache_once():
    """At smoke size and at seamless's full size (8 prompts, a window of
    2112, 2048 frames): the decoder's weights without cross ``wk``/``wv``
    and the tied head, read once; the self-attention cache's ``ctx + 1``
    positions read and one written; the cross cache read once."""
    for cfg, batch, window in ((smoke_config(ARCH).with_(dtype="float32"), 2, 80),
                               (get_config(ARCH).with_(dtype="float32"), 8, 2112)):
        params, cache = _meta_model(cfg, batch, window)
        shapes = M.param_shapes(cfg)
        used = sum(int(np.prod(s)) for k, s in shapes.items()
                   if not k.startswith("encoder/") and not k.endswith(("cross/wk", "cross/wv")))
        L, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
        ctx = window - 10
        self_kv = L * 2 * batch * kv * hd * 4 * (ctx + 2)
        cross = L * 2 * batch * (window - 64) * kv * hd * 4
        got = chip_smoke.decode_step_bytes(cfg, params, cache, batch, ctx, 0)
        assert got == used * 4 + self_kv + cross
    assert used == 553_721_856 + 256_256 * 1024 + 1024            # full size
    assert cross == 24 * 2 * 8 * 2048 * 16 * 64 * 4                 # 3.22 GB
    assert 9.7e9 < got < 9.9e9


# the five models phase 12 and phases 13-14 serve (granite in the CLI smoke),
# at the served depth, 8 prompts in a window of 2112: (arch, depth, ctx,
# routed (layer, expert) pairs, bytes the bound counted before the
# encoder-decoder repair)
SERVED_BYTES = [("yi-6b", None, 2048, 0, 25_345_277_952),
                ("yi-6b", None, 2100, 37, 25_399_803_904),
                ("mamba2-1.3b", None, 2048, 0, 7_026_929_664),
                ("granite-moe-3b-a800m", None, 2100, 37, 3_670_415_360),
                ("deepseek-v2-236b", 4, 2100, 37, 9_462_910_976),
                ("jamba-v0.1-52b", 8, 2048, 0, 7_103_980_416),
                ("jamba-v0.1-52b", 8, 2100, 37, 33_179_181_952)]


@pytest.mark.parametrize("arch,depth,ctx,experts,want", SERVED_BYTES)
def test_decode_bytes_of_the_decoder_only_models_are_unchanged(arch, depth, ctx, experts,
                                                               want):
    cfg = get_config(arch).with_(dtype="float32")
    cfg = cfg.with_(num_layers=depth) if depth else cfg
    params, cache = _meta_model(cfg, 8, 2112)
    assert chip_smoke.decode_step_bytes(cfg, params, cache, 8, ctx, experts) == want


def test_chip_smoke_trajectory_cuts_the_encoder_too(capsys):
    chip_smoke.trajectory(ARCH, device="cpu", base=smoke_config(ARCH))
    out = capsys.readouterr().out
    assert f"[trajectory] arch={ARCH} depth=1 enc_layers=1 " in out, out


def test_chip_smoke_encdec_phase_rehearses_on_the_cpu(capsys, monkeypatch):
    """``chip_smoke.py``'s phase 15 with the smoke config on the CPU: the
    training job through both lanes (byte-exact restore, first loss near ln
    V, aux 0, no launches), serving with the frames passed to the prefill
    and to teacher forcing on the same run (no dense-MoE run after it)."""
    calls = []
    prefill, forward_hidden = M.prefill, M.forward_hidden

    def spy_prefill(cfg, params, batch):
        calls.append(("prefill", tuple(batch["enc_embeds"].shape)))
        return prefill(cfg, params, batch)

    def spy_forward(cfg, params, batch):      # teacher forcing's, not the trainer's
        if torch.is_inference_mode_enabled():
            calls.append(("forward", tuple(batch["enc_embeds"].shape)))
        return forward_hidden(cfg, params, batch)
    monkeypatch.setattr(M, "prefill", spy_prefill)
    monkeypatch.setattr(M, "forward_hidden", spy_forward)
    cfg = smoke_config(ARCH)
    train, serve = chip_smoke.encdec_phase(
        "cpu", device="cpu", train_cfg=cfg, serve_cfg=cfg.with_(dtype="float32"), job=JOB,
        serve=dict(batch=2, prompt=16, gen=8))
    assert train == serve == NO_LAUNCHES
    out = capsys.readouterr().out
    assert "restored_vs_snapshot_byte_exact=True" in out, out
    assert out.count("[encdec] step=") == 6 and "first_loss=" in out
    assert out.count("teacher_forcing_positions=8") == 1
    assert calls == [("prefill", (2, 16, 64)), ("forward", (2, 16, 64))]
