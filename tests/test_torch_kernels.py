"""Kernels of the PyTorch port: plain versions held against the JAX package
(Pallas kernels in interpret mode and the jnp oracles) on the CPU.  The
hand-written kernels themselves are held against these plain versions on
the card in ``test_torch_cuda_kernels.py``.

Inputs come from a numpy seed and go to both packages.  Tolerances are those
of the reference's kernel tests: fp32 forward 2e-5, gradients 1e-4, rmsnorm
1e-6, pack byte for byte."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.pack import (pack_leaves_pallas,  # noqa: E402
                                packed_snapshot_to_host)
from repro_torch.checkpoint.reshard import snapshot_to_host  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (_rows_aligned,  # noqa: E402
                                                 flash_attention_fwd)
from repro_torch.kernels.moe_gemm import NN, TN, ragged_gemm  # noqa: E402
from repro_torch.kernels.pack import pack_leaves  # noqa: E402


def _qkv(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


# -- flash attention ----------------------------------------------------------

@pytest.mark.parametrize("S,hd,causal", [(32, 16, True), (32, 32, True),
                                         (128, 16, True), (128, 32, True),
                                         (32, 16, False)])
def test_flash_plain_matches_jax_kernel_and_oracle(S, hd, causal):
    q, k, v = _qkv(S + hd, 2, S, 4, 2, hd)          # GQA G = 2
    out = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    jk = jops.flash_attention(q, k, v, causal=causal, interpret=True)
    jo = jref.flash_attention_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(jk), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("S,hd", [(32, 16), (128, 32)])
def test_flash_grads_match_jax_grad(S, hd):
    q, k, v = _qkv(7 * S + hd, 2, S, 4, 2, hd)
    g = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)

    def jloss(q_, k_, v_):
        return jnp.sum(jops.flash_attention(q_, k_, v_, causal=True,
                                            interpret=True) * g)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (ops.flash_attention(tq, tk, tv, causal=True) * torch.from_numpy(g)).sum().backward()
    for t, j in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=1e-4,
                                   rtol=1e-4)


def test_flash_lse_plain_is_row_logsumexp():
    q, k, v = _qkv(3, 1, 32, 4, 2, 16)
    out, lse = flash_attention_fwd(*map(torch.from_numpy, (q, k, v)))
    s = np.einsum("bshd,bthd->bhst", q, np.repeat(k, 2, axis=2)) * 16 ** -0.5
    s = np.where(np.tril(np.ones((32, 32), bool)), s, -np.inf)
    exp = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), exp, atol=2e-5, rtol=2e-5)


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    ops.reset_launch_counts()
    q, k, v = map(torch.from_numpy, _qkv(0, 1, 32, 4, 2, 16))
    ops.flash_attention(q, k, v)
    ops.rmsnorm(q, torch.ones(16))
    pack_leaves([q, k])
    ops.ssd(q, torch.ones(1, 32, 4), torch.zeros(4), k[..., :8], k[..., 8:],
            chunk=8)
    ops.ragged_mm(q[0], k[0].transpose(1, 2), torch.full((32,), 2, dtype=torch.int32))
    assert ops.launch_counts() == {"flash_attention": 0, "moe_gemm": 0, "pack": 0,
                                   "rmsnorm": 0, "ssd": 0}


def test_launch_counts_by_dtype_count_no_cpu_call_and_reset():
    ops.reset_launch_counts()
    q, k, v = map(torch.from_numpy, _qkv(0, 1, 32, 4, 2, 16))
    ops.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    pack_leaves([q.bfloat16(), k.bfloat16()])
    none = {"flash_attention": {}, "moe_gemm": {}, "pack": {}, "rmsnorm": {}, "ssd": {}}
    assert ops.launch_counts_by_dtype() == none
    pack_leaves.launches["bfloat16"] += 3        # as card launches leave them
    pack_leaves.launches["float32"] += 1
    assert ops.launch_counts_by_dtype()["pack"] == {"bfloat16": 3, "float32": 1}
    assert ops.launch_counts()["pack"] == 4      # the total is derived
    ops.reset_launch_counts()
    assert ops.launch_counts_by_dtype() == none
    assert ops.launch_counts() == dict.fromkeys(none, 0)


def test_wrappers_refuse_devices_they_do_not_serve():
    # cpu, cuda and meta (the dry-run's trace) are served; fake tensors of a
    # FakeTensorMode stand in for a device that is not
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        q = torch.empty((1, 32, 4, 16), device="xpu")
        k = torch.empty((1, 32, 2, 16), device="xpu")
        with pytest.raises(ValueError):
            flash_attention_fwd(q, k, k)
        with pytest.raises(ValueError):
            ops.rmsnorm(q, torch.empty(16, device="xpu"))
        with pytest.raises(ValueError):
            pack_leaves([q])
        with pytest.raises(ValueError):
            ragged_gemm(NN, torch.empty((2, 8, 16), device="xpu"),
                        torch.empty((2, 16, 4), device="xpu"),
                        torch.empty(2, dtype=torch.int32, device="xpu"))
    with pytest.raises(ValueError):           # widths that do not chain
        ragged_gemm(NN, torch.zeros(2, 8, 16), torch.zeros(2, 12, 4), torch.zeros(2).int())
    with pytest.raises(ValueError):           # a count for each expert
        ragged_gemm(TN, torch.zeros(2, 8, 16), torch.zeros(2, 8, 4), torch.zeros(3).int())
    with pytest.raises(ValueError):           # head_dim the kernel lacks
        flash_attention_fwd(*(torch.zeros(1, 8, 2, 24) for _ in range(3)))


def test_flash_wrapper_copies_only_views_its_copies_cannot_read():
    fused = torch.zeros((2, 8, 3 * 64 + 1))
    skewed = fused[..., :128].reshape(2, 8, 2, 64)         # rows 193 floats apart
    assert _rows_aligned(skewed) is not skewed
    base = torch.zeros((2, 8, 4 * 64 + 4))
    good = base[..., 4:260].reshape(2, 8, 4, 64)           # 16-byte offset
    assert _rows_aligned(good) is good
    odd = base[..., 1:257].reshape(2, 8, 4, 64)
    copy = _rows_aligned(odd)
    assert copy is not odd and copy.is_contiguous() and torch.equal(copy, odd)
    bf = torch.zeros((1, 4, 2, 32), dtype=torch.bfloat16)
    assert _rows_aligned(bf) is bf


PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelPf
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 16 bytes smem, 380 bytes cmem[0]
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Function properties for _Z5otherv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 356 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_smem_and_spills():
    assert _build.ptxas_report(PTXAS_LOG) == [
        {"kernel": "_Z6kernelPf", "registers": 168, "smem_static": 16,
         "spill_stores": 4, "spill_loads": 12},
        {"kernel": "_Z5otherv", "registers": 40, "smem_static": 0,
         "spill_stores": 0, "spill_loads": 0}]
    assert "-v" in _build.NVCC_FLAGS and "-Xptxas" in _build.NVCC_FLAGS


# -- rmsnorm ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 64), (2, 5, 128)])
def test_rmsnorm_plain_matches_jax_kernel(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1:]).astype(np.float32)
    out = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    exp = jops.rmsnorm(x, w, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), atol=1e-6, rtol=1e-6)


# -- pack -----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_pack_plain_is_byte_identical_to_jax_kernel(dtype):
    rng = np.random.default_rng(5)
    leaves = [(rng.standard_normal(s) * 100).astype(dtype)
              for s in ((1,), (1023,), (1025,), (3, 5, 7))]
    out = pack_leaves([torch.from_numpy(a) for a in leaves])
    exp = np.asarray(pack_leaves_pallas([jnp.asarray(a) for a in leaves],
                                        interpret=True))
    assert out.numpy().dtype == exp.dtype and out.shape == exp.shape
    assert out.numpy().tobytes() == exp.tobytes()


def test_fused_snapshot_equals_unfused_and_jax():
    rng = np.random.default_rng(9)
    tree = {"a": {"w": rng.standard_normal((3, 5)).astype(np.float32),
                  "n": np.arange(1025, dtype=np.int32)},
            "b/c": rng.standard_normal(1023).astype(np.float32),
            "empty": np.zeros((0, 4), np.float32),
            "count": np.int32(7)}
    ttree = {k: ({kk: torch.from_numpy(np.asarray(vv)) for kk, vv in v.items()}
                 if isinstance(v, dict) else torch.from_numpy(np.asarray(v)))
             for k, v in tree.items()}
    fused = snapshot_to_host(ttree, fused=True)
    plain = snapshot_to_host(ttree)
    jfused = packed_snapshot_to_host(
        jax.tree.map(jnp.asarray, tree), interpret=True)
    assert list(fused) == list(plain) == list(jfused)
    for key in plain:
        assert fused[key].shape == plain[key].shape == jfused[key].shape
        assert fused[key].tobytes() == plain[key].tobytes() == jfused[key].tobytes()


def test_snapshot_copies_instead_of_aliasing():
    t = torch.zeros(4)
    for fused in (False, True):
        snap = snapshot_to_host({"t": t}, fused=fused)
        t.add_(1.0)                               # in-place optimizer update
        assert not np.any(snap["t"] == t.numpy())
