"""The PyTorch port's hand-written kernels against their plain versions, on
the card.  Every test is marked ``cuda`` and skips where there is no card
(a CUDA or Triton kernel has no CPU mode); the decision is taken inside each
test, so every pytest worker collects the same tests.  Run them on the card
with ``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``.

This file needs no JAX: the machine with the card has none."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import (AsyncCheckpointer,  # noqa: E402
                                    DiskCheckpointStore, flatten_tree,
                                    restore_from_host, snapshot_to_host)
from repro_torch.configs import ATTN, FF_MOE, SSM, smoke_config  # noqa: E402
from repro_torch.core.elastic import (ElasticTrainer, TrainJobConfig,  # noqa: E402
                                      local_slots)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.blocked import blocked_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.moe_gemm import (NN, NT, TN, ragged_gemm,  # noqa: E402
                                          ragged_gemm_ref)
from repro_torch.kernels.pack import pack_leaves  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_fwd  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402


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
                                         (1, 100, 8, 2, 64), (2, 256, 8, 1, 128),
                                         (2, 256, 24, 8, 64),      # granite-moe: group 3
                                         (1, 128, 36, 4, 128)])    # starcoder2: group 9
def test_flash_kernel_matches_plain_on_card(dtype, B, S, H, KV, hd):
    dev = _card()
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dev, dt) for a in _qkv(S, B, S, H, KV, hd))
    before = ops.launch_counts()["flash_attention"]
    out, lse = flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
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


def _flash_against_plain(dev, dtype, B, S, H, KV, hd, causal):
    """One launch of the flash kernel held against the plain version: output
    at 2e-5 (float32) or 2e-2 (bf16), LSE at 1e-4, launches up by one."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dev, dt)
               for a in _qkv(S + H + KV, B, S, H, KV, hd))
    before = ops.launch_counts()["flash_attention"]
    out, lse = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert out.dtype == dt and tuple(out.shape) == (B, S, H, hd)
    tol = 2e-5 if dtype == "float32" else 2e-2
    exp = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                  causal=causal).to(dt)
    torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(
        lse, ref.attention_lse_ref(q.float(), k.float(), causal=causal),
        atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,hd,causal", [
    (1, 2048, 32, 4, 128, True),          # the yi-6b path's shape
    (1, 100, 8, 2, 128, True),            # S not a multiple of the tiles
    (1, 1000, 8, 2, 128, True),
    (1, 1000, 4, 4, 64, True),            # G = 1
    (1, 300, 8, 1, 128, True),            # G = 8
    (2, 200, 4, 2, 32, False)])
def test_flash_kernel_redesign_shapes_on_card(dtype, B, S, H, KV, hd, causal):
    _flash_against_plain(_card(), dtype, B, S, H, KV, hd, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S", [(1, 2048), (2, 300)])
def test_flash_kernel_at_jambas_group_on_card(dtype, B, S):
    """jamba-v0.1-52b's attention layer: 32 query heads over 8 KV heads of
    128 (group 4), causal, at its serving prompt and off the tiles."""
    _flash_against_plain(_card(), dtype, B, S, 32, 8, 128, True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S", [(1, 2048), (2, 300)])
def test_flash_kernel_at_seamless_heads_on_card(dtype, B, S):
    """seamless-m4t-large-v2's decoder self-attention: 16 query heads over
    16 KV heads of 64 (group 1), causal, at its serving prompt and off the
    tiles."""
    _flash_against_plain(_card(), dtype, B, S, 16, 16, 64, True)


@pytest.mark.cuda
@pytest.mark.parametrize("S,hd", [(96, 32), (1000, 128)])
def test_flash_kernel_non_causal_bf16_on_card(S, hd):
    _flash_against_plain(_card(), "bfloat16", 2, S, 8, 2, hd, False)


@pytest.mark.cuda
def test_flash_kernel_reads_strided_and_misaligned_views_on_card():
    dev = _card()
    q, k, v = (torch.from_numpy(a).to(dev) for a in _qkv(5, 1, 160, 8, 2, 64))
    # q, k, v as slices of one fused projection, then shifted by one element
    fused = torch.cat([q.reshape(1, 160, -1), k.reshape(1, 160, -1),
                       v.reshape(1, 160, -1)], dim=-1)
    odd = torch.cat([fused.new_zeros(1, 160, 1), fused], dim=-1)[..., 1:]
    for t in (fused, odd):
        qs = t[..., :512].reshape(1, 160, 8, 64)
        ks = t[..., 512:640].reshape(1, 160, 2, 64)
        vs = t[..., 640:].reshape(1, 160, 2, 64)
        before = ops.launch_counts()["flash_attention"]
        out, _ = flash_attention_fwd(qs, ks, vs)
        assert ops.launch_counts()["flash_attention"] == before + 1
        torch.testing.assert_close(out, ref.flash_attention_ref(q, k, v),
                                   atol=2e-5, rtol=2e-5)


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
    before = ops.launch_counts()["ssd"]
    out = ssd_scan_fwd(x, dt, a_log, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd"] == before + 1 and out.dtype == dt_
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


def _ssd_against_plain(x, dt, a_log, b, c, chunk, exp_inputs=None):
    """One launch of the SSD kernel held against ``ssd_chunked_ref`` and the
    plain split, at the reference's tolerance; launches up by one."""
    tol = 1e-4 if x.dtype == torch.float32 else 5e-2   # tests/test_kernels.py:79
    before = ops.launch_counts()["ssd"]
    out = ssd_scan_fwd(x, dt, a_log, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd"] == before + 1 and out.dtype == x.dtype
    assert torch.isfinite(out).all()
    args = exp_inputs or (x, dt, a_log, b, c)
    for exp in (ref.ssd_chunked_ref(*args, chunk=chunk),
                ref.ssd_split_ref(*args, chunk=chunk)[0]):
        torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [128, 256, 2048])      # nc = 1, 2 and 16 chunks
def test_ssd_kernel_chunk_counts_at_shard_widths_on_card(dtype, L):
    dev = _card()
    x, dt, a_log, b, c = _ssd_inputs(dev, L, 1, L, 8, 64, 1, 128)
    dt_ = getattr(torch, dtype)
    _ssd_against_plain(x.to(dt_), dt, a_log, b.to(dt_), c.to(dt_), 128)


@pytest.mark.cuda
@pytest.mark.parametrize("dt_shift", [0.0, -6.0])
def test_ssd_kernel_three_groups_on_card(dt_shift):
    dev = _card()
    _ssd_against_plain(*_ssd_inputs(dev, 9, 2, 384, 6, 64, 3, 128,
                                    dt_shift=dt_shift), 128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strided", [False, True])
def test_ssd_kernel_at_jambas_heads_and_state_on_card(dtype, strided):
    """jamba-v0.1-52b's SSD widths (128 heads of head dim 64, one group of
    d_state 16, chunk 128) at a short sequence; ``strided``: x, B and C as
    slices of one activation of width 128 x 64 + 2 x 16, as the model
    hands them over."""
    dev = _card()
    B, L, H, P, N = 2, 384, 128, 64, 16
    x, dt, a_log, b, c = _ssd_inputs(dev, 16, B, L, H, P, 1, N)
    dt_ = getattr(torch, dtype)
    x, b, c = x.to(dt_), b.to(dt_), c.to(dt_)
    if strided:
        fused = torch.cat([x.reshape(B, L, -1), b.reshape(B, L, -1),
                           c.reshape(B, L, -1)], dim=-1)
        args = (fused[..., :H * P].reshape(B, L, H, P), dt, a_log,
                fused[..., H * P:H * P + N].reshape(B, L, 1, N),
                fused[..., H * P + N:].reshape(B, L, 1, N))
        assert not args[0].is_contiguous()
        _ssd_against_plain(*args, 128, exp_inputs=(x, dt, a_log, b, c))
    else:
        _ssd_against_plain(x, dt, a_log, b, c, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])          # 1: rows not 16-byte aligned
@pytest.mark.parametrize("scale", [1.0, 20.0])       # 20: decay past exp's limit
def test_ssd_kernel_strided_views_and_large_decay_on_card(offset, scale):
    dev = _card()
    B, L, H, P, N = 2, 512, 8, 64, 128
    x, dt, a_log, b, c = _ssd_inputs(dev, 4, B, L, H, P, 1, N)
    dt = dt * scale
    if scale > 1:    # dt*A sums far past fp32's exp limit within a chunk
        assert float((dt[:, :128] * torch.exp(a_log)).sum(1).max()) > 89.0
    fused = torch.cat([x.new_zeros(B, L, offset), x.reshape(B, L, -1),
                       b.reshape(B, L, -1), c.reshape(B, L, -1)], dim=-1)
    xs = fused[..., offset:offset + H * P].reshape(B, L, H, P)
    bs = fused[..., offset + H * P:offset + H * P + N].reshape(B, L, 1, N)
    cs = fused[..., offset + H * P + N:].reshape(B, L, 1, N)
    assert not xs.is_contiguous()
    _ssd_against_plain(xs, dt, a_log, bs, cs, 128, exp_inputs=(x, dt, a_log, b, c))


@pytest.mark.cuda
def test_fused_snapshot_of_a_bf16_group_is_byte_exact_on_card():
    """A fused host snapshot of bfloat16 leaves on the card: one launch of
    the pack kernel's 2-byte instantiation for the group, ``V2`` host views
    holding the leaves' bits, and a restore to the card with the same bits."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    tree = {"w": torch.randn((4096, 1024), device=dev, generator=gen).bfloat16(),
            "b": torch.randn((1000,), device=dev, generator=gen).bfloat16(),
            "s": torch.tensor(1.5, device=dev, dtype=torch.bfloat16)}
    want = {k: v.cpu().view(torch.int16).numpy().tobytes() for k, v in tree.items()}
    before = ops.launch_counts_by_dtype()["pack"].get("bfloat16", 0)
    host = snapshot_to_host(tree, fused=True)
    assert ops.launch_counts_by_dtype()["pack"]["bfloat16"] == before + 1
    assert all(host[k].dtype == np.dtype("V2") for k in tree)
    assert {k: host[k].tobytes() for k in tree} == want
    back = restore_from_host(host, tree, dev)
    for k, t in tree.items():
        assert back[k].device.type == "cuda" and back[k].dtype == torch.bfloat16
        assert torch.equal(back[k].view(torch.int16), t.view(torch.int16)), k


@pytest.mark.cuda
def test_fused_async_snapshot_lands_the_pre_update_bytes_on_card(tmp_path):
    """``AsyncCheckpointer.submit(fused=True)`` returns only after the packed
    device-to-host copy is complete: an in-place update launched at once
    does not reach the checkpoint, and the one float32 group is one pack
    launch."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    tree = {"w": torch.randn((4096, 1024), device=dev, generator=gen),
            "b": torch.randn((1000,), device=dev, generator=gen)}
    want = {k: v.cpu().numpy().tobytes() for k, v in tree.items()}
    store = DiskCheckpointStore(str(tmp_path))
    ac = AsyncCheckpointer(store)
    before = ops.launch_counts()["pack"]
    ac.submit("j", 1, tree, fused=True)
    assert ops.launch_counts()["pack"] == before + 1
    for v in tree.values():
        v.mul_(2.0).add_(1.0)
    ac.close()
    flat, _ = store.load("j")
    assert {k: flat[k].tobytes() for k in want} == want
    assert tree["w"].cpu().numpy().tobytes() != want["w"]


@pytest.mark.cuda
def test_trainer_save_disk_async_then_step_on_card(tmp_path):
    """The trainer's fused ``save_disk_async`` followed at once by an
    in-place ``step()``: the checkpoint holds the pre-step state, and the
    snapshot launched the pack kernel once per dtype group (float32
    parameters and moments, int32 counts)."""
    dev = _card()
    t = ElasticTrainer(smoke_config("yi-6b"),
                       TrainJobConfig(global_batch=8, seq_len=32, total_steps=4),
                       local_slots(2), device=dev)
    t.step()
    want = {k: v.detach().cpu().numpy().tobytes()
            for k, v in flatten_tree(t.state_tree()).items()}
    store = DiskCheckpointStore(str(tmp_path))
    before = ops.launch_counts()["pack"]
    t.save_disk_async(store, "j", fused=True)
    assert ops.launch_counts()["pack"] == before + 2
    t.step()
    t.ckpt_barrier()
    flat, manifest = store.load("j")
    assert manifest["step"] == 1
    assert {k: flat[k].tobytes() for k in want} == want
    assert t.params["embed"].detach().cpu().numpy().tobytes() != want["params/embed"]
    t._async_ckpt.close()


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["gather", "dense"])
def test_moe_forward_on_card_matches_the_cpu(impl):
    """granite-moe's MoE layer at smoke size (4 experts, top-2, capacity
    factor 0.25 so tokens drop) on the card against the same layer on the
    CPU: output and aux within 2e-5, gradients of x and every expert leaf
    within 1e-4; the gather's sort, dispatch and combine run on the card."""
    dev = _card()
    cfg = smoke_config("granite-moe-3b-a800m").with_(dtype="float32")
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=0.25))
    D, E, F = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff_expert
    rng = np.random.default_rng(0)
    f32 = lambda fan, *shape: (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)
    flat = {"router": f32(D, D, E), "w_gate": f32(D, E, D, F), "w_up": f32(D, E, D, F),
            "w_down": f32(F, E, F, D)}
    x, r = f32(1, 2, 64, D), f32(1, 2, 64, D)
    out = {}
    for where in ("cpu", dev):
        p = M.from_numpy_flat(flat, device=where)
        xt = torch.from_numpy(x).to(where).requires_grad_()
        moe.set_moe_impl(impl)
        try:
            y, aux = moe.moe_forward(cfg, p, xt)
        finally:
            moe.set_moe_impl("gather")
        (torch.sum(y * torch.from_numpy(r).to(where)) + aux).backward()
        out[str(where)] = [y.detach(), aux.detach(), xt.grad] + [p[k].grad for k in sorted(p)]
    cpu, card = out["cpu"], out[str(dev)]
    for i, (a, b) in enumerate(zip(cpu, card)):
        tol = 2e-5 if i < 2 else 1e-4
        torch.testing.assert_close(b.cpu(), a, atol=tol, rtol=tol)


# the ragged expert products' cases: (E, T, K, N, rows[e]), each expert's
# count of kept slot rows of T.  granite-moe-3b-a800m's layer at R=4 (40
# experts, two sequences of capacity 512, d_model 1536, expert width 512)
# with counts 0, 1, off the 128-row tile, on it and full, the rest falling
# as 1/rank; deepseek-v2-236b's and jamba-v0.1-52b's widths at a few
# experts; a decode step (capacity 1, 8 sequences); widths off every tile
# and off 16-byte rows
_ZIPF = [min(1024, 3000 // r) for r in range(1, 34)]
RAGGED_CASES = [
    (40, 1024, 1536, 512, [0, 1, 127, 128, 129, 640, 1024] + _ZIPF),
    (4, 640, 5120, 1536, [640, 0, 257, 3]),
    (2, 256, 4096, 14336, [200, 256]),
    (40, 8, 1536, 512, [i % 9 for i in range(40)]),
    (3, 300, 100, 37, [300, 131, 0])]


def _ragged_operands(dev, E, T, K, N, rows, seed):
    """X (E,T,K), W (E,K,N), G (E,T,N) float32 on the card, rows of X and G
    past rows[e] NaN (the kernel must not read them), W scaled so every
    product is of order 1; and X and G with those rows zero, as the gather
    lays them out, for ``torch.bmm``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((E, T, K), device=dev, generator=g)
    w = torch.randn((E, K, N), device=dev, generator=g) / K ** 0.5
    gy = torch.randn((E, T, N), device=dev, generator=g) / N ** 0.5
    past = torch.arange(T, device=dev)[None, :, None] >= rows[:, None, None]
    return ([x.masked_fill(past, float("nan")), w, gy.masked_fill(past, float("nan"))],
            [x.masked_fill(past, 0.0), w, gy.masked_fill(past, 0.0)], past)


@pytest.mark.cuda
@pytest.mark.parametrize("E,T,K,N,counts", RAGGED_CASES,
                         ids=["granite", "deepseek", "jamba", "decode", "odd-widths"])
def test_ragged_expert_products_match_bmm_on_card(E, T, K, N, counts):
    """The three forms of the ragged kernel in float32 (TF32 off) against
    ``torch.bmm`` over the same layout with the rows past each count zero:
    within atol = rtol = 1e-4, as both sum in float32 in different orders
    (the kernel along k in one pass, cuBLAS in its own tiling), over up to
    14,336 terms of order 1/sqrt(K) each, where rounding stays near 1e-5;
    1e-4 is the reference's gradient tolerance.  The rows the kernel must
    not read hold NaN, the output rows past each count are exactly zero, an
    expert with no rows gets an exactly zero weight gradient, two runs give
    the same bits, and each call is one launch."""
    dev = _card()
    assert not torch.backends.cuda.matmul.allow_tf32
    rows = torch.tensor(counts, dtype=torch.int32, device=dev)
    (x, w, gy), (x0, _, gy0), past = _ragged_operands(dev, E, T, K, N, rows, E + K)
    cases = [(NN, x, w, x0, w, past), (NT, gy, w, gy0, w, past),
             (TN, x, gy, x0, gy0, None)]
    for form, a, b, a0, b0, zero_rows in cases:
        before = ops.launch_counts()["moe_gemm"]
        got = ragged_gemm(form, a, b, rows)
        again = ragged_gemm(form, a, b, rows)
        torch.cuda.synchronize()
        assert ops.launch_counts()["moe_gemm"] == before + 2
        want = ragged_gemm_ref(form, a0, b0)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert torch.equal(got, again), form
        assert bool(torch.isfinite(got).all()), form
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4, msg=f"form {form}")
        if zero_rows is not None:
            assert not got.masked_select(zero_rows.expand_as(got)).any(), form
    empty = [e for e, n in enumerate(counts) if n == 0]
    assert not got[empty].any()


def _serve(cfg, params, tokens, prompt, steps, frames=None):
    """Prefill (an encoder-decoder's encoder over ``frames``), pad to the
    window, ``steps`` decode steps fed the known tokens; returns ([prefill
    logits, decode logits...], the cache, the launch counts the prefill
    added, those the decode steps added)."""
    before = ops.launch_counts()
    extra = {} if frames is None else {"enc_embeds": frames}
    cache, logits = M.prefill(cfg, params, {"tokens": tokens[:, :prompt], **extra})
    after = ops.launch_counts()
    cache = M.pad_cache(cfg, cache, prompt, prompt + steps)
    out = [logits]
    for t in range(prompt, prompt + steps):
        logits, cache = M.decode_step(cfg, params, cache, tokens[:, t:t + 1], t)
        out.append(logits)
    end = ops.launch_counts()
    return (out, cache, {k: after[k] - before[k] for k in end},
            {k: end[k] - after[k] for k in end})


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi-6b", "granite-moe-3b-a800m", "mamba2-1.3b",
                                  "deepseek-v2-236b", "jamba-v0.1-52b"])
def test_serving_on_card_matches_the_cpu(arch):
    """A prefill of 16 tokens and 4 decode steps at smoke size, on the card
    against the same on the CPU (logits and every cache leaf within 2e-5);
    on the card a prefill launches flash attention once a GQA layer and the
    SSD scan once a Mamba-2 layer (an MLA layer attends through the blocked
    twin: no launch; jamba's block, flash once and the SSD 7 times), and a
    decode step neither; each pass launches the ragged expert products
    three times an MoE layer (gate, up, down)."""
    dev = _card()
    cfg = smoke_config(arch).with_(dtype="float32")
    params = M.init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 20)))
    want, want_cache, cpu_prefill, cpu_decode = _serve(cfg, params, tokens, 16, 4)
    assert not any(cpu_prefill.values()) and not any(cpu_decode.values())
    card_params = M.from_numpy_flat(M.to_numpy_flat(params), device=dev)
    got, cache, prefill, decode = _serve(cfg, card_params, tokens.to(dev), 16, 4)
    mixers = [cfg.mixer_at(i) for i in range(cfg.num_layers)]
    products = 3 * sum(cfg.ff_at(i) == FF_MOE for i in range(cfg.num_layers))
    launched = {"flash_attention": mixers.count(ATTN), "ssd": mixers.count(SSM),
                "moe_gemm": products}
    assert prefill == {k: launched.get(k, 0) for k in prefill}
    assert decode == {k: 4 * products if k == "moe_gemm" else 0 for k in decode}
    for a, b in zip(want, got):
        torch.testing.assert_close(b.cpu(), a, atol=2e-5, rtol=2e-5)
    want_flat, got_flat = flatten_tree(want_cache), flatten_tree(cache)
    assert list(got_flat) == list(want_flat)
    for k, a in want_flat.items():
        assert got_flat[k].dtype == a.dtype, k
        torch.testing.assert_close(got_flat[k].cpu(), a, atol=2e-5, rtol=2e-5, msg=k)


@pytest.mark.cuda
def test_serving_refuses_a_mamba2_prompt_off_the_chunk_on_card():
    dev = _card()
    cfg = smoke_config("mamba2-1.3b").with_(dtype="float32")
    params = M.init_params(cfg, 0, device=dev)
    with pytest.raises(ValueError, match="sequence length 12 is not a multiple of chunk 8"):
        M.prefill(cfg, params, {"tokens": torch.zeros((2, 12), dtype=torch.long, device=dev)})


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Sk,H,KV,hd,hdv,causal,q_pos0,kv_len,block_k", [
    (256, 256, 8, 8, 192, 128, True, 0, None, 64),      # MLA's head dims (train, prefill)
    (100, 100, 6, 2, 64, 64, True, 0, None, 48),        # GQA, tail off the block
    (32, 80, 4, 4, 24, 16, True, 40, 70, 32),           # a later query, masked tail
    (32, 48, 4, 4, 16, 24, False, 0, None, 16)])        # non-causal, hdv != hd
def test_blocked_twin_on_card_matches_the_cpu(Sq, Sk, H, KV, hd, hdv, causal, q_pos0,
                                              kv_len, block_k):
    """The blocked-attention twin (plain torch, no kernel) on the card
    against the CPU: output within 2e-5, every gradient within 5e-4."""
    dev = _card()
    rng = np.random.default_rng(Sq)
    arrays = [rng.standard_normal(shape).astype(np.float32) for shape in
              ((2, Sq, H, hd), (2, Sk, KV, hd), (2, Sk, KV, hdv), (2, Sq, H, hdv))]
    out = {}
    for where in ("cpu", dev):
        q, k, v, r = (torch.from_numpy(a).to(where) for a in arrays)
        for t in (q, k, v):
            t.requires_grad_()
        y = blocked_attention(q, k, v, causal, None, q_pos0, kv_len, block_k)
        (y * r).sum().backward()
        out[str(where)] = [y.detach(), q.grad, k.grad, v.grad]
    for i, (a, b) in enumerate(zip(out["cpu"], out[str(dev)])):
        tol = 2e-5 if i == 0 else 5e-4
        torch.testing.assert_close(b.cpu(), a, atol=tol, rtol=tol)


@pytest.mark.cuda
def test_deepseek_train_step_on_card_matches_the_cpu():
    """One trainer step of the deepseek smoke model (MLA, the dense prefix
    layer, stacked MoE layers with shared experts) on the card against the
    CPU from the same parameters: loss and aux within 2e-5, grad norm within
    1e-4, every parameter after the update within 1e-4; the MLA layers
    attend through the blocked twin (no launch), and each replica launches
    the ragged expert products 12 times an MoE layer: gate, up and down in
    the forward and in the recompute, and each one's two gradients."""
    dev = _card()
    cfg = smoke_config("deepseek-v2-236b")
    job = TrainJobConfig(global_batch=8, seq_len=32, total_steps=4, seed=3)
    cpu = ElasticTrainer(cfg, job, local_slots(2), device="cpu")
    card = ElasticTrainer(cfg, job, local_slots(2), device=dev)
    with torch.no_grad():
        for k, t in flatten_tree(card.params).items():
            t.copy_(flatten_tree(cpu.params)[k])
    before = ops.launch_counts()
    want, got = cpu.step(), card.step()
    torch.cuda.synchronize()
    moe_layers = sum(cfg.ff_at(i) == FF_MOE for i in range(cfg.num_layers))
    assert ops.launch_counts() == {**before,
                                   "moe_gemm": before["moe_gemm"] + 12 * moe_layers * 2}
    assert got["aux"] > 0
    for k, tol in (("loss", 2e-5), ("aux", 2e-5), ("grad_norm", 1e-4)):
        assert abs(got[k] - want[k]) <= tol * max(1.0, abs(want[k])), (k, got[k], want[k])
    want_p, got_p = flatten_tree(cpu.params), flatten_tree(card.params)
    for k, a in want_p.items():
        torch.testing.assert_close(got_p[k].detach().cpu(), a.detach(), atol=1e-4,
                                   rtol=1e-4, msg=k)


@pytest.mark.cuda
def test_jamba_train_step_on_card_matches_the_cpu():
    """The jamba smoke model (one period-8 block: 7 Mamba-2 layers, attention
    at sub3, MoE on the odd subs) on the card against the CPU from the same
    parameters: the loss, aux and every gradient of the trainers' first
    global batch (2e-5, 1e-4), then two trainer steps at R=2 (loss and aux
    within 2e-5, grad norm within 1e-4, every parameter after each step
    within 1e-4 but at the elements whose first gradient is rounding, as
    ``tests/test_torch_hybrid.py::_rounding`` defines them: not 0 and below
    1e-7, where AdamW's first step goes by about the learning rate in the
    direction of the rounding), each replica's forward and recompute
    launching flash once and the SSD 7 times, and each replica the ragged
    expert products 12 times an MoE layer (3 in the forward, 3 in the
    recompute, 6 gradients)."""
    dev = _card()
    cfg = smoke_config("jamba-v0.1-52b")
    job = TrainJobConfig(global_batch=8, seq_len=32, total_steps=4, seed=3)
    cpu = ElasticTrainer(cfg, job, local_slots(2), device="cpu")
    card = ElasticTrainer(cfg, job, local_slots(2), device=dev)
    with torch.no_grad():
        for k, t in flatten_tree(card.params).items():
            t.copy_(flatten_tree(cpu.params)[k])
    batch0 = {k: torch.from_numpy(v).long() for k, v in cpu.stream.global_batch_at(0).items()}
    grads = {}
    for where in ("cpu", dev):
        params = M.from_numpy_flat(M.to_numpy_flat(cpu.params), device=where)
        loss, m = M.loss_fn(cfg, params, {k: v.to(where) for k, v in batch0.items()})
        loss.backward()
        grads[str(where)] = [loss.detach(), m["aux"].detach()] + [
            t.grad for t in flatten_tree(params).values()]
    for i, (a, b) in enumerate(zip(grads["cpu"], grads[str(dev)])):
        tol = 2e-5 if i < 2 else 1e-4
        torch.testing.assert_close(b.cpu(), a, atol=tol, rtol=tol)
    g0 = dict(zip(flatten_tree(cpu.params), grads["cpu"][2:]))
    rounding = {k: (g != 0) & (g.abs() < 1e-7) for k, g in g0.items()}
    assert sum(int(r.sum()) for r in rounding.values()) < 64
    before = ops.launch_counts()
    for _ in range(2):
        want, got = cpu.step(), card.step()
        assert got["aux"] > 0
        for k, tol in (("loss", 2e-5), ("aux", 2e-5), ("grad_norm", 1e-4)):
            assert abs(got[k] - want[k]) <= tol * max(1.0, abs(want[k])), (k, got[k], want[k])
        want_p, got_p = flatten_tree(cpu.params), flatten_tree(card.params)
        for k, a in want_p.items():
            a = a.detach()
            ok = (got_p[k].detach().cpu() - a).abs() <= 1e-4 + 1e-4 * a.abs()
            assert bool((ok | rounding[k]).all()), k
            if not bool(ok.all()):
                print(f"{k}: beyond 1e-4 where the first gradient is {g0[k][~ok].tolist()}")
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "flash_attention": 2 * 2 * 2, "moe_gemm": 2 * 2 * 4 * 12, "pack": 0, "rmsnorm": 0,
        "ssd": 2 * 2 * 2 * 7}


@pytest.mark.cuda
def test_seamless_serving_on_card_matches_the_cpu():
    """The seamless smoke model (2 encoder and 2 decoder layers) served on
    the card against the CPU from the same parameters, tokens and encoder
    frames: a prefill of 16 tokens over 12 frames, then 4 decode steps;
    logits and every cache leaf (the cross cache included) within 2e-5; a
    prefill launches flash once a decoder layer (the encoder's and the
    cross attention go through the blocked twin), a decode step none."""
    dev = _card()
    cfg = smoke_config("seamless-m4t-large-v2").with_(dtype="float32")
    params = M.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 20)))
    frames = torch.from_numpy(rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32))
    want, want_cache, cpu_prefill, cpu_decode = _serve(cfg, params, tokens, 16, 4, frames)
    assert not any(cpu_prefill.values()) and not any(cpu_decode.values())
    card_params = M.from_numpy_flat(M.to_numpy_flat(params), device=dev)
    got, cache, prefill, decode = _serve(cfg, card_params, tokens.to(dev), 16, 4,
                                         frames.to(dev))
    assert prefill == {"flash_attention": cfg.num_layers, "moe_gemm": 0, "pack": 0,
                       "rmsnorm": 0, "ssd": 0}
    assert not any(decode.values())
    for a, b in zip(want, got):
        torch.testing.assert_close(b.cpu(), a, atol=2e-5, rtol=2e-5)
    want_flat, got_flat = flatten_tree(want_cache), flatten_tree(cache)
    assert list(got_flat) == list(want_flat)
    assert got_flat["blocks/sub0/cross/ck"].shape == (cfg.num_layers, 2, 12, 4, 16)
    for k, a in want_flat.items():
        torch.testing.assert_close(got_flat[k].cpu(), a, atol=2e-5, rtol=2e-5, msg=k)


@pytest.mark.cuda
def test_seamless_train_step_on_card_matches_the_cpu():
    """The seamless smoke model on the card against the CPU from the same
    parameters: the loss and every gradient (the encoder's included) of the
    trainers' first global batch (2e-5, 1e-4), then one trainer step at R=2
    (loss within 2e-5, grad norm within 1e-4), each replica's forward and
    recompute launching flash once a decoder layer."""
    dev = _card()
    cfg = smoke_config("seamless-m4t-large-v2")
    job = TrainJobConfig(global_batch=8, seq_len=32, total_steps=4, seed=3)
    cpu = ElasticTrainer(cfg, job, local_slots(2), device="cpu")
    card = ElasticTrainer(cfg, job, local_slots(2), device=dev)
    with torch.no_grad():
        for k, t in flatten_tree(card.params).items():
            t.copy_(flatten_tree(cpu.params)[k])
    batch0 = cpu.stream.global_batch_at(0)
    assert batch0["enc_embeds"].dtype == np.float32
    grads = {}
    for where in ("cpu", dev):
        params = M.from_numpy_flat(M.to_numpy_flat(cpu.params), device=where)
        batch = {k: torch.from_numpy(v).to(where) for k, v in batch0.items()}
        batch["tokens"], batch["labels"] = batch["tokens"].long(), batch["labels"].long()
        loss, _ = M.loss_fn(cfg, params, batch)
        loss.backward()
        grads[str(where)] = [loss.detach()] + [t.grad for t in flatten_tree(params).values()]
    assert any(k.startswith("encoder/") for k in flatten_tree(cpu.params))
    for i, (a, b) in enumerate(zip(grads["cpu"], grads[str(dev)])):
        tol = 2e-5 if i == 0 else 1e-4
        torch.testing.assert_close(b.cpu(), a, atol=tol, rtol=tol)
    before = ops.launch_counts()
    want, got = cpu.step(), card.step()
    torch.cuda.synchronize()
    for k, tol in (("loss", 2e-5), ("grad_norm", 1e-4)):
        assert abs(got[k] - want[k]) <= tol * max(1.0, abs(want[k])), (k, got[k], want[k])
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "flash_attention": 2 * 2 * cfg.num_layers, "moe_gemm": 0, "pack": 0, "rmsnorm": 0,
        "ssd": 0}


# -- the wrappers' meta branches (the dry-run) against the kernels ----------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_wrappers_match_the_kernels_outputs_on_card(dtype):
    """Each wrapper's meta output has the shapes and dtypes of its CUDA
    output, and a meta call adds no launch."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((2, 256, 8, 64), device=dev, generator=g).to(dtype)
    k = torch.randn((2, 256, 2, 64), device=dev, generator=g).to(dtype)
    x = torch.randn((2, 256, 8, 32), device=dev, generator=g).to(dtype)
    dt = torch.rand((2, 256, 8), device=dev, generator=g)
    a_log = torch.randn(8, device=dev, generator=g)
    b = torch.randn((2, 256, 2, 64), device=dev, generator=g).to(dtype)
    leaves = [torch.randn(s, device=dev, generator=g).to(dtype)
              for s in ((3, 4), (1,), (9, 130))]
    w = torch.randn(64, device=dev, generator=g).to(dtype)
    calls = {
        "flash_attention": lambda m: flash_attention_fwd(m(q), m(k), m(k)),
        "ssd": lambda m: (ssd_scan_fwd(m(x), m(dt), m(a_log), m(b), m(b), chunk=128),),
        "pack": lambda m: (pack_leaves([m(t) for t in leaves]),),
        "rmsnorm": lambda m: (ops.rmsnorm(m(q).reshape(-1, 64), m(w)),),
    }
    if dtype == torch.float32:          # bf16 takes torch.bmm: no launch
        xe = torch.randn((2, 256, 32), device=dev, generator=g)
        we = torch.randn((2, 32, 64), device=dev, generator=g)
        rows = torch.tensor([256, 3], dtype=torch.int32, device=dev)
        calls["moe_gemm"] = lambda m: (ragged_gemm(NN, m(xe), m(we), m(rows)),)
    for name, call in calls.items():
        ops.reset_launch_counts()
        real = call(lambda t: t)
        torch.cuda.synchronize()
        assert ops.launch_counts()[name] == 1, name
        meta = call(lambda t: t.to("meta"))
        assert ops.launch_counts()[name] == 1, name
        for r, m in zip(real, meta):
            assert m.is_meta and m.shape == r.shape and m.dtype == r.dtype, name
