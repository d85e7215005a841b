"""The PyTorch port's AdamW and LR schedule against the JAX package: one
update on the same grads and state, and the warmup-cosine curve."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.reshard import flatten_tree as jflatten  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
from repro.optim import warmup_cosine as jwarmup_cosine  # noqa: E402
from repro_torch.checkpoint.reshard import flatten_tree  # noqa: E402
from repro_torch.models.params import from_numpy_flat  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, warmup_cosine  # noqa: E402


def _tree(rng, scale=1.0):
    return {"w": (rng.standard_normal((4, 6)) * scale).astype(np.float32),
            "norm": {"g": (1 + rng.standard_normal(6) * scale).astype(np.float32)},
            "emb": (rng.standard_normal((8, 3)) * scale).astype(np.float32)}


@pytest.mark.parametrize("count,grad_scale", [(0, 0.1), (4, 10.0)])
def test_adamw_update_matches_jax(count, grad_scale):
    """One step from the same state; grad_scale 10 exercises clipping."""
    rng = np.random.default_rng(count)
    p, g = _tree(rng), _tree(rng, grad_scale)
    m, v = _tree(rng, 0.01), jax.tree.map(np.abs, _tree(rng, 0.01))
    lr = 2e-3
    jstate = {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
              "count": jnp.asarray(count, jnp.int32)}
    jp, jst, jom = jadamw_update(JAdamWConfig(), jax.tree.map(jnp.asarray, g),
                                 jstate, jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(lr, jnp.float32))
    to_t = lambda t: from_numpy_flat(jflatten(t), device="cpu",
                                     requires_grad=False)
    tp, tg = to_t(p), to_t(g)
    tstate = {"m": to_t(m), "v": to_t(v),
              "count": torch.tensor(count, dtype=torch.int32)}
    om = adamw_update(AdamWConfig(), tg, tstate, tp, torch.tensor(lr))
    np.testing.assert_allclose(float(om["grad_norm"]), float(jom["grad_norm"]),
                               rtol=1e-6)
    assert int(tstate["count"]) == int(jst["count"]) == count + 1
    assert tstate["count"].dtype == torch.int32
    for ours, ref in ((tp, jp), (tstate["m"], jst["m"]), (tstate["v"], jst["v"])):
        ref = jflatten(ref)
        for k, t in flatten_tree(ours).items():
            np.testing.assert_allclose(t.numpy(), np.asarray(ref[k]), atol=1e-7,
                                       rtol=1e-6, err_msg=k)


def test_adamw_decays_every_leaf_including_norms():
    p = {"norm": torch.ones(3)}
    st = adamw_init(p)
    adamw_update(AdamWConfig(), {"norm": torch.zeros(3)}, st, p, 0.5)
    torch.testing.assert_close(p["norm"], torch.full((3,), 1 - 0.5 * 0.1))
    assert st["m"]["norm"].dtype == torch.float32


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 30, 49, 50, 80])
def test_warmup_cosine_matches_jax(step):
    kw = dict(peak_lr=3e-3, warmup_steps=10, total_steps=50)
    ours = warmup_cosine(step, **kw)
    ref = jwarmup_cosine(jnp.asarray(step, jnp.int32), **kw)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)
