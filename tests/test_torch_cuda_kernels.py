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
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.elastic import (ElasticTrainer, TrainJobConfig,  # noqa: E402
                                      local_slots)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
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
