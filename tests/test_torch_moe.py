"""The PyTorch port's MoE layer against the JAX package on the CPU, at the
granite-moe-3b-a800m smoke size in float32: the router, the load-balance
loss, ``moe_forward`` through the dense and the gather dispatch (capacity
factor 1.25, 100, and 0.25, which drops tokens), and the gradients of the
output and the aux loss with respect to x and every expert leaf.

Inputs and parameters come from a numpy seed; the parameters reach the port
through ``from_numpy_flat``.  Tolerances are the reference's
(``tests/test_kernels.py``): 2e-5 forward, 1e-4 gradients."""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import moe_gemm  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCH = "granite-moe-3b-a800m"
B, S = 2, 16
FWD_TOL, GRAD_TOL = 2e-5, 1e-4
# (implementation, capacity factor): at 0.25 the capacity is max(4, 2) = 4
# slots per expert and sequence for 8 assignments each on average
CASES = [("dense", 1.25), ("gather", 1.25), ("gather", 100.0), ("gather", 0.25)]
# (capacity factor, batch, sequence) of the slot layout's cases: 0.25 drops
# tokens, 100 none; a sequence of 1 is a decode step (capacity 1)
LAYOUT_CASES = [(0.25, B, S), (1.25, B, S), (100.0, B, S), (1.25, 4, 1)]


def _cfgs(cf):
    jcfg = jsmoke_config(ARCH).with_(dtype="float32")
    cfg = smoke_config(ARCH).with_(dtype="float32")
    return (jcfg.with_(moe=dataclasses.replace(jcfg.moe, capacity_factor=cf)),
            cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=cf)))


def _inputs(seed=0):
    """x, a cotangent for y, and the layer's parameters, from a numpy seed."""
    cfg = smoke_config(ARCH)
    D, E, F = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff_expert
    rng = np.random.default_rng(seed)
    f32 = lambda fan_in, *shape: (rng.standard_normal(shape) / np.sqrt(fan_in)
                                  ).astype(np.float32)
    p = {"router": f32(D, D, E), "w_gate": f32(D, E, D, F), "w_up": f32(D, E, D, F),
         "w_down": f32(F, E, F, D)}
    return f32(1, B, S, D), f32(1, B, S, D), p


@contextlib.contextmanager
def _impl(module, impl):
    """``module``'s MoE implementation set to ``impl`` for a with-block."""
    module.set_moe_impl(impl)
    try:
        yield
    finally:
        module.set_moe_impl("gather")


def _jax_run(impl, cf, x, r, p):
    jcfg, _ = _cfgs(cf)

    def f(params, xx):
        y, aux = jmoe.moe_forward(jcfg, params, xx)
        return jnp.sum(y * r) + aux, (y, aux)
    with _impl(jmoe, impl):
        (_, (y, aux)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    return np.asarray(y), float(aux), {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx)


def _port_run(impl, cf, x, r, p):
    _, cfg = _cfgs(cf)
    params = M.from_numpy_flat(p, device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    with _impl(moe, impl):
        y, aux = moe.moe_forward(cfg, params, xt)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    return (y.detach().numpy(), float(aux.detach()), {k: t.grad.numpy() for k, t in params.items()},
            xt.grad.numpy())


def test_router_probs_and_load_balance_loss_match_jax():
    x, _, p = _inputs(1)
    E = p["router"].shape[1]
    jprobs = jmoe.router_probs({"router": jnp.asarray(p["router"])}, jnp.asarray(x))
    probs = moe.router_probs({"router": torch.from_numpy(p["router"])}, torch.from_numpy(x))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=FWD_TOL, rtol=FWD_TOL)
    _, jids = jax.lax.top_k(jprobs, 2)
    _, ids = torch.topk(probs, 2, dim=-1)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(float(moe.load_balance_loss(probs, ids, E)),
                               float(jmoe.load_balance_loss(jprobs, jids, E)),
                               atol=FWD_TOL, rtol=FWD_TOL)
    # the sums behind it add across batch shards to the whole batch's loss
    halves = [moe.balance_stats(probs[i:i + 1], ids[i:i + 1], E) for i in range(B)]
    psum, counts = (sum(t) for t in zip(*halves))
    np.testing.assert_allclose(float(moe.balance_loss(psum, counts, B * S, E)),
                               float(moe.load_balance_loss(probs, ids, E)), rtol=1e-6)


@pytest.mark.parametrize("impl,cf", CASES)
def test_moe_forward_matches_jax(impl, cf):
    x, r, p = _inputs()
    jy, jaux, _, _ = _jax_run(impl, cf, x, r, p)
    y, aux, _, _ = _port_run(impl, cf, x, r, p)
    np.testing.assert_allclose(y, jy, atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(aux, jaux, atol=FWD_TOL, rtol=FWD_TOL)
    assert aux > 0


@pytest.mark.parametrize("impl,cf", CASES)
def test_moe_gradients_match_jax(impl, cf):
    x, r, p = _inputs(2)
    _, _, jgp, jgx = _jax_run(impl, cf, x, r, p)
    _, _, gp, gx = _port_run(impl, cf, x, r, p)
    np.testing.assert_allclose(gx, jgx, atol=GRAD_TOL, rtol=GRAD_TOL)
    assert sorted(gp) == sorted(jgp)
    for k in jgp:
        np.testing.assert_allclose(gp[k], jgp[k], atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=k)


def test_low_capacity_drops_tokens():
    """At capacity factor 0.25 some assignments are dropped: the gather's
    output differs from the dense oracle's, as the reference's does."""
    x, r, p = _inputs()
    dense, _, _, _ = _port_run("dense", 0.25, x, r, p)
    low, _, _, _ = _port_run("gather", 0.25, x, r, p)
    assert np.abs(low - dense).max() > 1e-3


def test_gather_equals_dense_at_capacity_100():
    """With capacity factor 100 nothing is dropped: the gather dispatch
    equals the all-experts oracle (the reference's own test,
    ``tests/test_models.py``)."""
    x, r, p = _inputs(3)
    dy, daux, dgp, dgx = _port_run("dense", 100.0, x, r, p)
    gy, gaux, ggp, ggx = _port_run("gather", 100.0, x, r, p)
    np.testing.assert_allclose(gy, dy, atol=1e-5, rtol=1e-5)
    assert gaux == daux
    np.testing.assert_allclose(ggx, dgx, atol=GRAD_TOL, rtol=GRAD_TOL)
    for k in dgp:
        np.testing.assert_allclose(ggp[k], dgp[k], atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=k)


def test_gather_is_deterministic():
    """The combine and the gather's backward sum without atomics: two runs
    give the same bits."""
    x, r, p = _inputs(4)
    a, b = _port_run("gather", 1.25, x, r, p), _port_run("gather", 1.25, x, r, p)
    assert a[0].tobytes() == b[0].tobytes() and a[3].tobytes() == b[3].tobytes()
    assert all(a[2][k].tobytes() == b[2][k].tobytes() for k in a[2])


@pytest.mark.parametrize("cf,b,s", LAYOUT_CASES)
def test_gather_layout_puts_each_experts_kept_rows_first(cf, b, s):
    """The gather's compact slot layout: expert e's rows[e] = sum over
    sequences of min(count, C) kept assignments fill the first rows[e] slots
    of its block of B*C, sequence by sequence, each sequence's in order of
    assignment (the drop order of the stable sort), and every slot past them
    is empty and zero; the ragged kernel computes each rows[e] rounded up to
    its row tile.  (Outputs and gradients on this layout are held to the
    JAX package and the dense oracle by the tests above.)"""
    _, cfg = _cfgs(cf)
    E, k, D = cfg.moe.num_experts, cfg.moe.experts_per_token, cfg.d_model
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((b, s, D)).astype(np.float32))
    ids = torch.from_numpy(rng.random((b, s, E))).topk(k, dim=-1).indices
    xg, rows, (slot_of_asg, asg_of_slot) = moe._gather_dispatch(cfg, x, ids)
    T = xg.shape[1]
    C = T // b
    flat = ids.reshape(b, s * k).numpy()
    counts = np.stack([np.bincount(r, minlength=E) for r in flat])
    assert rows.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy(), np.minimum(counts, C).sum(0))
    want = np.full(b * s * k, E * T)              # dropped: the sentinel
    for e in range(E):
        slot = e * T
        for bb in range(b):
            kept = [n for n in range(s * k) if flat[bb, n] == e][:C]
            want[bb * s * k + np.array(kept, dtype=int)] = slot + np.arange(len(kept))
            slot += len(kept)
    np.testing.assert_array_equal(slot_of_asg.numpy(), want)
    filled = (asg_of_slot < b * s * k).view(E, T)
    assert torch.equal(filled, torch.arange(T)[None, :] < rows[:, None])
    tok = (asg_of_slot // k).view(E, T)
    for e in range(E):
        n = int(rows[e])
        assert torch.equal(xg[e, :n], x.reshape(b * s, D)[tok[e, :n]])
        assert not xg[e, n:].any()
    tiles = sum(min(-(-int(n) // moe_gemm.ROW_TILE) * moe_gemm.ROW_TILE, T) for n in rows)
    assert int(moe_gemm.rows_computed(rows, T, torch.empty(0, device="meta"))) == tiles
    assert moe_gemm.rows_computed(rows, T, x) == E * T     # the plain bmm: every slot
