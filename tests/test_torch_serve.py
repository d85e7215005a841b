"""The port's serving path against the JAX package on the CPU: prefill's
last-token logits and every cache leaf, decode steps, a decode step from the
reference's own prefill cache, and decode against the port's own teacher
forcing, for the dense (SwiGLU, GELU, qk_norm), MoE, Mamba-2 and hybrid layouts;
the pieces (``_grouped_attention``, ``ssd_final_state``, ``make_cache``,
``pad_cache``, the encoder-decoder's cross cache); the analytic FLOP
models; and the ``launch.serve`` CLI.  The encoder-decoder's serving
parity is in ``tests/test_torch_encdec.py``.

The reference runs as its own CPU tests run it (Pallas off: blocked
attention and the jnp SSD), with ``jax.jit`` on ``prefill`` and
``decode_step``, and both packages' MoE layers in their dense form, as
``tests/test_models.py`` runs decode.  Parameters cross with
``from_numpy_flat``.  Tolerances: the reference's fp32 forward 2e-5, and its
decode-vs-teacher-forcing 2e-4 (``tests/test_models.py``)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.reshard import flatten_tree as jflatten  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import shape_applicable as jshape_applicable  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.moe import set_moe_impl as jset_moe_impl  # noqa: E402
from repro.utils import flops as jflops  # noqa: E402
from repro_torch.checkpoint.reshard import flatten_tree, nest_flat  # noqa: E402
from repro_torch.configs import (SHAPES, get_config, list_archs,  # noqa: E402
                                 shape_applicable, smoke_config)
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import attention, ssm  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.moe import set_moe_impl  # noqa: E402
from repro_torch.utils import flops  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["yi-6b", "mamba2-1.3b", "granite-moe-3b-a800m", "chameleon-34b",
         "starcoder2-7b", "jamba-v0.1-52b"]
# a prompt of two chunks of the Mamba-2 smoke config's 8, then GEN decode
# steps that fill the serving window exactly
B, S0, GEN = 2, 16, 8
TOL = 2e-5
TF_TOL = 2e-4


def _np_dtype(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _tokens(t):
    return torch.from_numpy(np.ascontiguousarray(t)).long()


def _port_serve(cfg, params, tokens):
    """The port's prefill (its cache as numpy, taken before decode writes
    into it), then GEN decode steps fed the known tokens; returns (prefill
    logits, prefill cache, [decode logits], final cache as numpy)."""
    cache, logits = M.prefill(cfg, params, {"tokens": _tokens(tokens[:, :S0])})
    prefill_cache = {k: v.numpy().copy() for k, v in flatten_tree(cache).items()}
    cache = M.pad_cache(cfg, cache, S0, S0 + GEN)
    steps = []
    for t in range(S0, S0 + GEN):
        lg, cache = M.decode_step(cfg, params, cache, _tokens(tokens[:, t:t + 1]), t)
        steps.append(lg.numpy())
    final = {k: v.numpy() for k, v in flatten_tree(cache).items()}
    return logits.numpy(), prefill_cache, steps, final


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """Both packages' serving runs of one smoke arch on the same parameters
    and tokens, and the port's teacher-forced logits."""
    jcfg = jsmoke_config(request.param).with_(dtype="float32")
    cfg = smoke_config(request.param).with_(dtype="float32")
    jset_moe_impl("dense")
    set_moe_impl("dense")
    try:
        jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
        flat = {k: np.asarray(v) for k, v in jflatten(jparams).items()}
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
            full = torch.matmul(hidden, M._head_weight(cfg, params))
        forced = full[..., :cfg.vocab_size].numpy()
        # one decode step in the port, from the reference's padded cache
        from_jax = M.from_numpy_flat(jpadded, device="cpu", requires_grad=False)
        first_from_jax, _ = M.decode_step(cfg, params, from_jax,
                                          _tokens(tokens[:, S0:S0 + 1]), S0)
    finally:
        jset_moe_impl("gather")
        set_moe_impl("gather")
    return dict(cfg=cfg, params=params, tokens=tokens,
                jlogits=np.asarray(jlogits), jprefill_cache=jprefill_cache,
                jsteps=jsteps, jfinal=jfinal, logits=logits,
                prefill_cache=prefill_cache, steps=steps, final=final,
                forced=forced, first_from_jax=first_from_jax.numpy())


def _assert_trees_close(ours: dict, want: dict, tol: float):
    assert list(ours) == list(want)
    for k, w in want.items():
        assert ours[k].shape == w.shape and str(ours[k].dtype) == str(w.dtype), k
        np.testing.assert_allclose(ours[k], w, atol=tol, rtol=tol, err_msg=k)


def test_prefill_logits_and_every_cache_leaf_match_jax(served):
    s = served
    assert s["logits"].shape == (B, s["cfg"].vocab_size)
    assert s["logits"].dtype == np.float32
    np.testing.assert_allclose(s["logits"], s["jlogits"], atol=TOL, rtol=TOL)
    _assert_trees_close(s["prefill_cache"], s["jprefill_cache"], TOL)


def test_decode_steps_and_final_cache_match_jax(served):
    s = served
    assert len(s["steps"]) == GEN
    for t, (ours, want) in enumerate(zip(s["steps"], s["jsteps"])):
        np.testing.assert_allclose(ours, want, atol=TOL, rtol=TOL,
                                   err_msg=f"decode step at pos {S0 + t}")
    _assert_trees_close(s["final"], s["jfinal"], TOL)


def test_decode_from_the_references_prefill_cache(served):
    np.testing.assert_allclose(served["first_from_jax"], served["jsteps"][0],
                               atol=TOL, rtol=TOL)


def test_decode_matches_the_ports_teacher_forcing(served):
    s = served
    got = np.stack([s["logits"], *s["steps"]], axis=1)       # positions S0-1 ..
    want = s["forced"][:, S0 - 1:S0 + GEN]
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) < TF_TOL


def test_gather_moe_decode_drops_nothing():
    """With one token a sequence the gather dispatch's capacity is 1 and a
    token's k experts are distinct: from one prefill cache, decode through
    the gather dispatch equals decode through the dense form."""
    cfg = smoke_config("granite-moe-3b-a800m").with_(dtype="float32")
    params = M.init_params(cfg, 3, device="cpu")
    tokens = _tokens(np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S0 + GEN)))
    cache, _ = M.prefill(cfg, params, {"tokens": tokens[:, :S0]})
    cache = flatten_tree(M.pad_cache(cfg, cache, S0, S0 + GEN))
    runs = {}
    for impl in ("dense", "gather"):
        set_moe_impl(impl)
        try:
            c = nest_flat({k: v.clone() for k, v in cache.items()})
            runs[impl] = [M.decode_step(cfg, params, c, tokens[:, t:t + 1], t)[0]
                          for t in range(S0, S0 + GEN)]
        finally:
            set_moe_impl("gather")
    for dense, gather in zip(runs["dense"], runs["gather"]):
        torch.testing.assert_close(gather, dense, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal,q_pos0,kv_len", [
    (True, 5, 8), (True, 0, None), (False, 0, 6), (True, 9, 10)])
def test_grouped_attention_matches_jax(causal, q_pos0, kv_len):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 10, 2, 8)).astype(np.float32) for _ in range(2))
    ours = attention._grouped_attention(*map(torch.from_numpy, (q, k, v)),
                                        causal=causal, q_pos0=q_pos0, scale=8 ** -0.5,
                                        kv_len=kv_len)
    want = jattn._grouped_attention(q, k, v, causal=causal, q_pos0=q_pos0,
                                    scale=8 ** -0.5,
                                    kv_len=None if kv_len is None else jnp.int32(kv_len))
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("G,dt_shift", [(1, 0.0), (2, 0.0), (2, -6.0)])
def test_ssd_final_state_matches_jax_and_the_split_scans_state(G, dt_shift):
    rng = np.random.default_rng(4)
    Bn, L, H, P, N = 2, 32, 4, 8, 8
    x = (0.5 * rng.standard_normal((Bn, L, H, P))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bn, L, H)) + dt_shift)).astype(np.float32)
    a_log = np.log(1 + 7 * rng.random(H)).astype(np.float32)
    b, c = ((0.3 * rng.standard_normal((Bn, L, G, N))).astype(np.float32)
            for _ in range(2))
    ours = ssm.ssd_final_state(*map(torch.from_numpy, (x, dt, a_log, b)))
    assert ours.dtype == torch.float32 and ours.shape == (Bn, H, P, N)
    want = jssm.ssd_final_state(x, dt, a_log, b, chunk=8)
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    _, split_state = ref.ssd_split_ref(*map(torch.from_numpy, (x, dt, a_log, b, c)),
                                       chunk=8)
    # the reference's SSD tolerance (tests/test_kernels.py)
    np.testing.assert_allclose(ours.numpy(), split_state.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_and_pad_cache_match_the_references_keys_shapes_and_dtypes(arch, dtype):
    jcfg = jsmoke_config(arch).with_(dtype=dtype)
    cfg = smoke_config(arch).with_(dtype=dtype)
    for prompt, window in ((5, 5), (5, 9)):
        ours = M.pad_cache(cfg, M.make_cache(cfg, 3, prompt, device="cpu"),
                           prompt, window)
        want = JM.pad_cache(jcfg, JM.make_cache(jcfg, 3, prompt), prompt, window)
        ours = {k: (tuple(v.shape), _np_dtype(v)) for k, v in flatten_tree(ours).items()}
        want = {k: (v.shape, str(v.dtype)) for k, v in jflatten(want).items()}
        assert ours == want and list(ours) == list(want)
    if cfg.ssm is not None:         # the state stays float32 in a bf16 model
        assert ours["blocks/sub0/ssm/h"][1] == "float32"
    else:
        assert ours["blocks/sub0/kv/k"][0][2] == 9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prompt,window,enc_len", [(5, 5, 7), (5, 9, 3), (4, 6, 4)])
def test_encoder_decoder_cache_matches_the_references_keys_shapes_and_dtypes(
        dtype, prompt, window, enc_len):
    """seamless-m4t-large-v2's smoke cache: every layer's self-attention
    ``kv`` beside its ``cross`` keys and values, (layers, batch, enc_len, kv
    heads, head dim), before and after ``pad_cache``, which pads only the
    ``kv`` leaves (with enc_len == prompt too)."""
    arch = "seamless-m4t-large-v2"
    jcfg = jsmoke_config(arch).with_(dtype=dtype)
    cfg = smoke_config(arch).with_(dtype=dtype)
    ours = M.make_cache(cfg, 3, prompt, enc_len=enc_len, device="cpu")
    want = JM.make_cache(jcfg, 3, prompt, enc_len=enc_len)
    for padded in (False, True):
        if padded:
            ours = M.pad_cache(cfg, ours, prompt, window)
            want = JM.pad_cache(jcfg, want, prompt, window)
        o = {k: (tuple(v.shape), _np_dtype(v)) for k, v in flatten_tree(ours).items()}
        w = {k: (v.shape, str(v.dtype)) for k, v in jflatten(want).items()}
        assert o == w and list(o) == list(w)
    assert o["blocks/sub0/cross/ck"] == ((2, 3, enc_len, 4, 16), dtype)
    assert o["blocks/sub0/kv/k"][0] == (2, 3, window, 4, 16)
    assert M.make_cache(get_config(arch), 1, 4, enc_len=6, device="meta")[
        "blocks"]["sub0"]["cross"]["cv"].shape == (24, 1, 6, 16, 64)


@pytest.mark.parametrize("arch", list_archs())
def test_flops_models_equal_the_references_exactly(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert list(SHAPES) == list(JSHAPES)
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        assert shape_applicable(cfg, shape) == jshape_applicable(jcfg, jshape)
        assert flops.cell_flops(cfg, shape) == jflops.cell_flops(jcfg, jshape)
        assert flops.cell_hbm_bytes(cfg, shape) == jflops.cell_hbm_bytes(jcfg, jshape)
        B, S = shape.global_batch, shape.seq_len
        assert flops.fwd_flops(cfg, B, S) == jflops.fwd_flops(jcfg, B, S)
        assert flops.decode_flops(cfg, B, S) == jflops.decode_flops(jcfg, B, S)


def _serve_cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("arch", ["yi-6b", "granite-moe-3b-a800m", "mamba2-1.3b"])
def test_serve_cli_on_the_cpu(arch):
    proc = _serve_cli("--arch", arch, "--smoke", "--device", "cpu", "--batch", "3",
                      "--prompt-len", "16", "--gen", "5")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("[serve] prefill 3x16: ")
    assert lines[1].startswith("[serve] decoded 4 steps x 3 seqs: ")
    assert lines[2] == "[serve] sample generations (token ids):"
    assert len(lines) == 6 and all(len(json.loads(line)) == 5 for line in lines[3:])


def test_serve_cli_refuses_a_mamba2_prompt_off_the_chunk():
    proc = _serve_cli("--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
                      "--prompt-len", "12")
    assert proc.returncode == 2
    assert "sequence length 12 is not a multiple of chunk 8" in proc.stderr


def test_serve_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    proc = _serve_cli("--arch", "yi-6b", "--smoke")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_prefill_refuses_a_mamba2_prompt_off_the_chunk_with_the_wrappers_message():
    cfg = smoke_config("mamba2-1.3b").with_(dtype="float32")
    params = M.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="sequence length 12 is not a multiple of chunk 8"):
        M.prefill(cfg, params, {"tokens": torch.zeros((2, 12), dtype=torch.long)})


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-1.3b"])
def test_chip_smoke_serving_phase_rehearses_on_the_cpu(arch):
    """``chip_smoke.py`` phase 12 for one model at smoke size on the CPU:
    no launches, decode held to teacher forcing (the Mamba-2 sequence padded
    to the chunk)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    counts = chip_smoke.serve_model(smoke_config(arch).with_(dtype="float32"), "cpu",
                                    batch=2, prompt=16, gen=8, device="cpu")
    assert counts == {k: {} for k in ("flash_attention", "moe_gemm", "pack", "rmsnorm",
                                              "ssd")}
