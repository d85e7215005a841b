"""The PyTorch port's hand-written kernels against their plain versions, on
the card.  Every test is marked ``cuda`` and skips where there is no card
(a CUDA or Triton kernel has no CPU mode); the decision is taken inside each
test, so every pytest worker collects the same tests.  Run them on the card
with ``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``.

This file needs no JAX: the machine with the card has none."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.pack import pack_leaves  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_fwd  # noqa: E402


def _qkv(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,hd", [(2, 16, 4, 2, 16), (2, 32, 4, 2, 16),
                                         (1, 100, 8, 2, 64), (2, 256, 8, 1, 128)])
def test_flash_kernel_matches_plain_on_card(dtype, B, S, H, KV, hd):
    dev = _card()
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dev, dt) for a in _qkv(S, B, S, H, KV, hd))
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    tol = 2e-5 if dtype == "float32" else 2e-2
    exp = ref.flash_attention_ref(q.float(), k.float(), v.float()).to(dt)
    torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref.attention_lse_ref(q.float(), k.float()),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_flash_kernel_non_causal_on_card():
    dev = _card()
    q, k, v = (torch.from_numpy(a).to(dev) for a in _qkv(1, 2, 96, 4, 2, 32))
    out, lse = flash_attention_fwd(q, k, v, causal=False)
    torch.testing.assert_close(out, ref.flash_attention_ref(q, k, v, causal=False),
                               atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, ref.attention_lse_ref(q, k, causal=False),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain_on_card(dtype):
    dev = _card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((37, 4096), device=dev, generator=g).to(dt)
    w = torch.randn((4096,), device=dev, generator=g).to(dt)
    tol = 1e-6 if dtype == "float32" else 1e-2
    torch.testing.assert_close(ops.rmsnorm(x, w).float(),
                               ref.rmsnorm_ref(x, w).float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16", "uint8", "float64"])
def test_pack_kernel_is_byte_identical_on_card(dtype):
    dev = _card()
    dt = getattr(torch, dtype)
    leaves = [(torch.arange(n, device=dev) % 251).to(dt).reshape(shape)
              for n, shape in ((1, (1,)), (1023, (1023,)), (1025, (1025,)),
                               (105, (3, 5, 7)), (5000, (50, 100)))]
    out = pack_leaves(leaves)
    exp = ref.pack_leaves_ref(leaves)
    assert out.shape == exp.shape
    assert torch.equal(out.view(torch.uint8), exp.view(torch.uint8))


def _ssd_inputs(dev, seed, B, L, H, P, G, N, dt_shift=0.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = 0.5 * torch.randn((B, L, H, P), device=dev, generator=g)
    dt = torch.nn.functional.softplus(
        torch.randn((B, L, H), device=dev, generator=g) + dt_shift)
    a_log = torch.log(1 + 7 * torch.rand((H,), device=dev, generator=g))
    b = 0.3 * torch.randn((B, L, G, N), device=dev, generator=g)
    c = 0.3 * torch.randn((B, L, G, N), device=dev, generator=g)
    return x, dt, a_log, b, c


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,P,G,N,chunk", [
    (1, 64, 4, 16, 1, 16, 16), (2, 64, 4, 16, 2, 16, 16),
    (2, 96, 6, 16, 3, 8, 32), (1, 32, 8, 16, 1, 16, 8),
    (1, 512, 4, 64, 1, 128, 128), (2, 384, 8, 64, 2, 128, 128)])
def test_ssd_kernel_matches_plain_on_card(dtype, B, L, H, P, G, N, chunk):
    dev = _card()
    dt_ = getattr(torch, dtype)
    x, dt, a_log, b, c = _ssd_inputs(dev, L + G, B, L, H, P, G, N)
    x, b, c = x.to(dt_), b.to(dt_), c.to(dt_)
    before = ssd_scan_fwd.launches
    out = ssd_scan_fwd(x, dt, a_log, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan_fwd.launches == before + 1 and out.dtype == dt_
    tol = 1e-4 if dtype == "float32" else 5e-2       # tests/test_kernels.py:79
    exp = ref.ssd_chunked_ref(x, dt, a_log, b, c, chunk=chunk)
    torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)
    if L <= 96:
        torch.testing.assert_close(out.float(),
                                   ref.ssd_ref(x, dt, a_log, b, c).float(),
                                   atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,P,G,N,chunk", [
    (2, 96, 6, 16, 3, 8, 32), (2, 1024, 4, 64, 1, 128, 128)])
def test_ssd_kernel_carries_long_memory_on_card(dtype, B, L, H, P, G, N, chunk):
    # dt about 0.004, the low end of Mamba-2's dt init: dt*A sums to a few
    # units over a chunk, and the state carried across chunks makes up about
    # half of y (by norm, past the first chunk)
    dev = _card()
    dt_ = getattr(torch, dtype)
    x, dt, a_log, b, c = _ssd_inputs(dev, L + G, B, L, H, P, G, N, dt_shift=-6.0)
    x, b, c = x.to(dt_), b.to(dt_), c.to(dt_)
    out = ssd_scan_fwd(x, dt, a_log, b, c, chunk=chunk)
    tol = 1e-4 if dtype == "float32" else 5e-2       # tests/test_kernels.py:79
    exp = ref.ssd_chunked_ref(x, dt, a_log, b, c, chunk=chunk)
    torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)
    if L <= 96:
        torch.testing.assert_close(out.float(),
                                   ref.ssd_ref(x, dt, a_log, b, c).float(),
                                   atol=tol, rtol=tol)


@pytest.mark.cuda
def test_ssd_kernel_reads_strided_views_and_survives_large_decay():
    dev = _card()
    x, dt, a_log, b, c = _ssd_inputs(dev, 3, 2, 256, 8, 32, 1, 64)
    # the model hands the kernel slices of one (B,L,conv_dim) activation
    xbc = torch.cat([x.reshape(2, 256, -1), b.reshape(2, 256, -1),
                     c.reshape(2, 256, -1)], dim=-1)
    xs = xbc[..., :256].reshape(2, 256, 8, 32)
    bs = xbc[..., 256:320].reshape(2, 256, 1, 64)
    cs = xbc[..., 320:].reshape(2, 256, 1, 64)
    assert not xs.is_contiguous()
    big = dt * 20                     # dt*A sums far past fp32's exp limit
    for d in (dt, big):
        out = ssd_scan_fwd(xs, d, a_log, bs, cs, chunk=64)
        exp = ref.ssd_chunked_ref(x, d, a_log, b, c, chunk=64)
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, exp, atol=1e-4, rtol=1e-4)
