"""The PyTorch port's Mamba-2 SSD path against the JAX package on the CPU: the
SSD scan (plain path of ``ops.ssd``) against the Pallas kernel in interpret
mode and the naive recurrence, its gradients against ``jax.grad`` of the jnp
chunked scan, the causal conv, the gated norm and the train-mode block.

Inputs come from a numpy seed and go to both packages.  Tolerances are the
reference's (``tests/test_kernels.py``): SSD fp32 1e-4, bf16 5e-2, gradients
1e-4; the block's pieces 2e-5, the model's forward tolerance."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.reshard import flatten_tree as jflatten  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_fwd  # noqa: E402
from repro_torch.models import layers, ssm  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

SHAPES = [(1, 64, 4, 16, 1, 16, 16),
          (2, 64, 4, 16, 2, 16, 16),
          (1, 128, 8, 32, 1, 32, 32),
          (2, 96, 6, 16, 3, 8, 32)]      # G = 3, chunk > some dims


def _ssd_inputs(seed, B, L, H, P, G, N, dt_shift=0.0, a_max=8.0):
    """x, dt (post-softplus), a_log, b, c as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, L, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)) + dt_shift)).astype(np.float32)
    a_log = np.log(rng.uniform(1.0, a_max, (H,))).astype(np.float32)
    b = (rng.standard_normal((B, L, G, N)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((B, L, G, N)) * 0.3).astype(np.float32)
    return x, dt, a_log, b, c


@pytest.mark.parametrize("B,L,H,P,G,N,chunk", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_matches_jax_kernel_and_oracle(B, L, H, P, G, N, chunk, dtype):
    x, dt, a_log, b, c = _ssd_inputs(L + 7 * G, B, L, H, P, G, N)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out = ops.ssd(torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
                  torch.from_numpy(a_log), torch.from_numpy(b).to(tdt),
                  torch.from_numpy(c).to(tdt), chunk=chunk)
    assert out.dtype == tdt and tuple(out.shape) == (B, L, H, P)
    jx, jb, jc = (jnp.asarray(a).astype(jdt) for a in (x, b, c))
    jk = jops.ssd(jx, dt, a_log, jb, jc, chunk=chunk, interpret=True)
    jo = jref.ssd_ref(jx, dt, a_log, jb, jc)
    tol = 5e-2 if dtype == "bfloat16" else 1e-4
    for exp in (jk, jo):
        np.testing.assert_allclose(out.float().numpy(), np.asarray(exp, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("G", [1, 2, 3])
def test_ssd_ref_recurrence_matches_jax_oracle(G):
    x, dt, a_log, b, c = _ssd_inputs(G, 2, 24, 6, 8, G, 8)
    out = ref.ssd_ref(*map(torch.from_numpy, (x, dt, a_log, b, c)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jref.ssd_ref(x, dt, a_log, b, c)),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,L,H,P,G,N,chunk", [SHAPES[1], SHAPES[3]])
def test_ssd_grads_match_jax_grad(B, L, H, P, G, N, chunk):
    # dt*A kept small enough that no masked decay overflows in the reference
    # (its where-after-exp gradient is NaN where one does; see the next test)
    x, dt, a_log, b, c = _ssd_inputs(3 * L + G, B, L, H, P, G, N, dt_shift=-3.0)
    g = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jssm.ssd_chunked(*a, chunk=chunk) * g),
                  argnums=(0, 1, 2, 3, 4))(x, dt, a_log, b, c)
    assert all(np.all(np.isfinite(np.asarray(j))) for j in jg)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, dt, a_log, b, c)]
    (ops.ssd(*ts, chunk=chunk) * torch.from_numpy(g)).sum().backward()
    for name, t, j in zip(("x", "dt", "a_log", "b", "c"), ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_ssd_large_dt_a_forward_matches_and_gradients_stay_finite():
    """With dt*A summing past fp32's exp limit over a chunk, the masked decay
    of the reference overflows above the diagonal: its forward selects the
    zeros, its gradient does not.  The port masks before exp."""
    x, dt, a_log, b, c = _ssd_inputs(11, 1, 64, 4, 16, 1, 16, dt_shift=3.0,
                                     a_max=16.0)
    A_dt = dt * np.exp(a_log)[None, None, :]
    assert A_dt[:, :32].sum(axis=1).max() > 89.0        # exp overflows in fp32
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, dt, a_log, b, c)]
    out = ops.ssd(*ts, chunk=32)
    exp = jssm.ssd_chunked(x, dt, a_log, b, c, chunk=32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(exp),
                               atol=1e-4, rtol=1e-4)
    out.sum().backward()
    for t in ts:
        assert torch.isfinite(t.grad).all()


def test_causal_conv_and_gated_rmsnorm_match_jax():
    rng = np.random.default_rng(2)
    u = rng.standard_normal((2, 12, 40)).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, (4, 40)).astype(np.float32)
    bias = rng.standard_normal(40).astype(np.float32)
    np.testing.assert_allclose(
        ssm._causal_conv(*map(torch.from_numpy, (u, w, bias))).numpy(),
        np.asarray(jssm._causal_conv(u, w, bias)), atol=2e-5, rtol=2e-5)
    x, z = (rng.standard_normal((2, 5, 64)).astype(np.float32) for _ in range(2))
    wn = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        layers.gated_rmsnorm(*map(torch.from_numpy, (x, z, wn)), 1e-5).numpy(),
        np.asarray(jlayers.gated_rmsnorm(x, z, wn, 1e-5)), atol=2e-5, rtol=2e-5)


def test_ssm_forward_train_matches_jax():
    jcfg = jsmoke_config("mamba2-1.3b").with_(dtype="float32")
    cfg = smoke_config("mamba2-1.3b").with_(dtype="float32")
    flat = {k: np.asarray(v) for k, v in
            jflatten(JM.init_params(jcfg, jax.random.PRNGKey(5))).items()}
    pre = "decoder/blocks/sub0/mixer/"
    layer0 = {k[len(pre):]: np.array(v[0]) for k, v in flat.items()
              if k.startswith(pre)}
    xin = np.random.default_rng(3).standard_normal((2, 32, 64)).astype(np.float32)
    exp, _ = jssm.ssm_forward(jcfg, layer0, jnp.asarray(xin), mode="train")
    out, _ = ssm.ssm_forward(cfg, {k: torch.from_numpy(v) for k, v in layer0.items()},
                             torch.from_numpy(xin))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), atol=2e-5, rtol=2e-5)


def test_cpu_ssd_counts_no_launch():
    ops.reset_launch_counts()
    x, dt, a_log, b, c = map(torch.from_numpy, _ssd_inputs(0, 1, 32, 2, 8, 1, 8))
    ops.ssd(x, dt, a_log, b, c, chunk=8)
    M.loss_fn(smoke_config("mamba2-1.3b").with_(dtype="float32"),
              M.init_params(smoke_config("mamba2-1.3b").with_(dtype="float32"),
                            0, device="cpu"),
              {"tokens": torch.zeros((1, 16), dtype=torch.long),
               "labels": torch.zeros((1, 16), dtype=torch.long)})
    assert ops.launch_counts()["ssd"] == 0 and not ssd_scan_fwd.launches


def test_ssd_wrapper_refuses_what_the_kernel_does_not_take():
    x, dt, a_log, b, c = map(torch.from_numpy, _ssd_inputs(0, 1, 32, 4, 8, 2, 8))
    with pytest.raises(ValueError):           # L not a multiple of the chunk
        ssd_scan_fwd(x, dt, a_log, b, c, chunk=12)
    with pytest.raises(ValueError):           # 3 groups do not divide 4 heads
        ssd_scan_fwd(x, dt, a_log, b[:, :, :1].expand(1, 32, 3, 8).contiguous(),
                     c[:, :, :1].expand(1, 32, 3, 8).contiguous(), chunk=8)
    with pytest.raises(TypeError):            # b in another type than x
        ssd_scan_fwd(x, dt, a_log, b.double(), c.double(), chunk=8)
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():                    # neither cuda, cpu nor meta
        other = [torch.empty(t.shape, dtype=t.dtype, device="xpu")
                 for t in (x, dt, a_log, b, c)]
        with pytest.raises(ValueError):
            ssd_scan_fwd(*other, chunk=8)


# -- the kernel's three-phase split, in plain PyTorch --------------------------

SPLIT_SHAPES = SHAPES + [(2, 32, 4, 16, 2, 16, 32),     # nc = 1 (L = chunk)
                         (1, 24, 6, 8, 3, 8, 64)]       # L < chunk: Q = L


@pytest.mark.parametrize("B,L,H,P,G,N,chunk", SPLIT_SHAPES)
def test_ssd_split_ref_matches_jax_chunked_and_final_state(B, L, H, P, G, N, chunk):
    x, dt, a_log, b, c = _ssd_inputs(5 * L + G, B, L, H, P, G, N)
    y, h = ref.ssd_split_ref(*map(torch.from_numpy, (x, dt, a_log, b, c)),
                             chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jssm.ssd_chunked(
        x, dt, a_log, b, c, chunk=chunk)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jssm.ssd_final_state(
        x, dt, a_log, b, chunk=chunk)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,L,H,P,G,N,chunk", SPLIT_SHAPES)
@pytest.mark.parametrize("dt_shift", [0.0, -6.0])     # -6: long memory
def test_ssd_split_ref_matches_chunked_ref(B, L, H, P, G, N, chunk, dt_shift):
    ts = map(torch.from_numpy, _ssd_inputs(L + 3 * G, B, L, H, P, G, N,
                                           dt_shift=dt_shift))
    x, dt, a_log, b, c = ts
    y, _ = ref.ssd_split_ref(x, dt, a_log, b, c, chunk=chunk)
    torch.testing.assert_close(y, ref.ssd_chunked_ref(x, dt, a_log, b, c,
                                                      chunk=chunk),
                               atol=1e-5, rtol=1e-5)


def test_ssd_split_ref_passes_no_overflow_past_the_exp_limit():
    """The state passing multiplies by exp(cum_Q), which underflows to 0 for
    a large decay; it never divides by it, so y stays finite and agrees."""
    x, dt, a_log, b, c = map(torch.from_numpy, _ssd_inputs(
        11, 1, 128, 4, 16, 1, 16, dt_shift=3.0, a_max=16.0))
    y, h = ref.ssd_split_ref(x, dt, a_log, b, c, chunk=32)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    torch.testing.assert_close(y, ref.ssd_chunked_ref(x, dt, a_log, b, c, chunk=32),
                               atol=1e-5, rtol=1e-5)
