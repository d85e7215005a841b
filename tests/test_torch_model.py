"""The PyTorch port's models against the JAX package on the CPU: the dense
yi-6b, yi-9b, starcoder2-7b (GELU), minitron-4b (squared ReLU) and
chameleon-34b (qk_norm) decoders, the granite-moe-3b-a800m MoE, the
deepseek-v2-236b MLA + MoE model, Mamba-2 mamba2-1.3b, the jamba-v0.1-52b
hybrid and the seamless-m4t-large-v2 encoder-decoder: configs, data
stream, parameter keys and shapes, parameter counts, the init
distributions, loss (aux included) and every gradient.

The JAX smoke parameters are carried across with ``from_numpy_flat``;
tolerances are the reference's (loss 2e-5, gradients 1e-4)."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.reshard import flatten_tree as jflatten  # noqa: E402
from repro.configs import count_active_params as jcount_active  # noqa: E402
from repro.configs import count_params as jcount_params  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.data import make_stream as jmake_stream  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.checkpoint.reshard import flatten_tree  # noqa: E402
from repro_torch.configs import get_config, list_archs, smoke_config  # noqa: E402
from repro_torch.data import make_stream  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ARCHS = ["yi-6b", "mamba2-1.3b", "granite-moe-3b-a800m", "yi-9b", "starcoder2-7b",
         "minitron-4b", "chameleon-34b", "deepseek-v2-236b", "jamba-v0.1-52b",
         "seamless-m4t-large-v2"]
FIELDS = ("name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads",
          "d_ff", "vocab_size", "resolved_head_dim", "padded_vocab", "rope_theta",
          "norm_eps", "ff_kind", "dtype", "vocab_pad_to", "default_mixer",
          "attn_every", "attn_offset", "tie_embeddings", "supports_long_context",
          "expected_params", "source", "qk_norm", "frontend", "enc_layers")
# full published sizes: (parameters, active parameters), the JAX package's
# count_params and count_active_params
FULL_SIZE = {"granite-moe-3b-a800m": (3_299_182_080, 881_690_112),
             "yi-9b": (8_829_407_232, 8_829_407_232),
             "starcoder2-7b": (7_399_051_776, 7_399_051_776),
             "minitron-4b": (4_190_309_376, 4_190_309_376),
             "chameleon-34b": (34_293_436_416, 34_293_436_416),
             "deepseek-v2-236b": (235_741_434_880, 21_329_280_000),
             "jamba-v0.1-52b": (51_460_000_640, 11_999_071_104),
             "seamless-m4t-large-v2": (1_369_827_328, 1_369_827_328)}
# deepseek-v2-236b at full width cut in depth: (layers, parameters, active)
DEEPSEEK_DEPTHS = [(1, 1_386_562_560, 1_386_562_560),       # the dense prefix layer
                   (2, 5_358_679_040, 1_724_574_720),
                   (4, 13_302_912_000, 2_400_599_040)]


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    jcfg = jsmoke_config(request.param).with_(dtype="float32")
    cfg = smoke_config(request.param).with_(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in jflatten(jparams).items()}
    batch = make_stream(cfg, seed=1, global_batch=4, seq_len=32).global_batch_at(0)
    batch["labels"][0, :5] = -1                      # exercise label masking
    return jcfg, cfg, jparams, flat, batch


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factory", ["get", "smoke"])
def test_configs_match_reference(factory, arch):
    ours = (get_config if factory == "get" else smoke_config)(arch)
    ref = (jget_config if factory == "get" else jsmoke_config)(arch)
    for f in FIELDS:
        assert getattr(ours, f) == getattr(ref, f), f
    for sub in ("ssm", "moe", "mla"):
        assert (getattr(ours, sub) is None) == (getattr(ref, sub) is None), sub
        if getattr(ref, sub) is not None:
            assert dataclasses.asdict(getattr(ours, sub)) == \
                dataclasses.asdict(getattr(ref, sub)), sub
    assert [ours.mixer_at(i) for i in range(ours.num_layers)] == \
        [ref.mixer_at(i) for i in range(ref.num_layers)]
    assert [ours.ff_at(i) for i in range(ours.num_layers)] == \
        [ref.ff_at(i) for i in range(ref.num_layers)]
    assert ours.layer_period() == ref.layer_period()
    assert ours.scan_layers() == ref.scan_layers()
    assert smoke_config(arch).padded_vocab == 256        # valid_vocab mask in use


def test_mamba2_full_size_param_count_equals_reference():
    # 48 x 25,849,280 per layer + the tied 50432 x 2048 embedding + final norm
    cfg = get_config("mamba2-1.3b")
    assert M.param_count(cfg) == 1_344_052_224 == jcount_params(jget_config("mamba2-1.3b"))
    assert "lm_head" not in M.param_shapes(cfg)
    assert M.param_shapes(cfg)["decoder/blocks/sub0/mixer/in_proj"] == (48, 2048, 8512)


def test_every_ported_arch_is_registered():
    assert list_archs() == sorted(ARCHS)


@pytest.mark.parametrize("arch", sorted(FULL_SIZE))
def test_full_size_param_counts_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    total, active = FULL_SIZE[arch]
    assert M.param_count(cfg) == M.count_params(cfg) == jcount_params(jcfg) == total
    assert M.count_active_params(cfg) == jcount_active(jcfg) == active
    assert M.param_shapes(cfg) == {k: v.shape for k, v in jflatten(
        jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))).items()}


@pytest.mark.parametrize("layers,total,active", DEEPSEEK_DEPTHS)
def test_deepseek_param_counts_at_full_width_cut_in_depth(layers, total, active):
    cfg = get_config("deepseek-v2-236b").with_(num_layers=layers)
    jcfg = jget_config("deepseek-v2-236b").with_(num_layers=layers)
    assert M.param_count(cfg) == jcount_params(jcfg) == total
    assert M.count_active_params(cfg) == jcount_active(jcfg) == active
    assert cfg.scan_layers() == (1, layers - 1)


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("layers_per_period", [1, 2])
def test_smoke_config_equals_the_references_field_for_field(arch, layers_per_period):
    ours = smoke_config(arch, layers_per_period=layers_per_period)
    ref = jsmoke_config(arch, layers_per_period=layers_per_period)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.scan_layers() == ref.scan_layers()


def test_full_width_depth4_param_count():
    # 2 x 262.1M embed/head + 4 x 173.0M per layer + the final norm
    cfg = get_config("yi-6b").with_(num_layers=4)
    assert M.param_count(cfg) == 2 * 64000 * 4096 + 4096 + 4 * (
        2 * 4096 + 4096 * 4096 * 2 + 2 * 4096 * 512 + 3 * 4096 * 11008)


@pytest.mark.parametrize("step", [0, 3, 11])
def test_stream_is_bit_identical(step):
    cfg = smoke_config("yi-6b")
    ours = make_stream(cfg, seed=3, global_batch=8, seq_len=32)
    ref = jmake_stream(jsmoke_config("yi-6b"), seed=3, global_batch=8, seq_len=32)
    a, b = ours.global_batch_at(step), ref.global_batch_at(step)
    for k in ("tokens", "labels"):
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    assert [ours.shard_bounds(i, 4) for i in range(4)] == \
        [ref.shard_bounds(i, 4) for i in range(4)]


def test_param_keys_and_shapes_equal_flatten_tree(smoke):
    _, cfg, _, flat, _ = smoke
    assert M.param_shapes(cfg) == {k: v.shape for k, v in flat.items()}
    ours = flatten_tree(M.init_params(cfg, 0, device="cpu"))
    assert list(ours) == list(flat)
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: v.shape for k, v in flat.items()}


def test_init_params_draw_reference_distributions():
    cfg = smoke_config("yi-6b").with_(d_model=256, d_ff=512, dtype="float32")
    p = flatten_tree(M.init_params(cfg, 0, device="cpu"))
    assert torch.all(p["final_norm"] == 1)
    w = p["decoder/blocks/sub0/ff/w_down"]
    assert abs(float(w.detach().std()) - 512 ** -0.5) < 0.05 * 512 ** -0.5
    assert all(t.requires_grad for t in p.values())


def test_mamba2_init_draws_reference_distributions():
    cfg = smoke_config("mamba2-1.3b").with_(d_model=256, dtype="float32")
    p = {k.split("/")[-1]: v.detach() for k, v in
         flatten_tree(M.init_params(cfg, 0, device="cpu")).items()}
    assert torch.all((p["a_log"] >= 0) & (p["a_log"] < math.log(16)))
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert torch.all((dt >= 1e-3 * (1 - 1e-5)) & (dt <= 1e-1 * (1 + 1e-5)))
    assert float(p["conv_w"].abs().max()) <= 0.5          # 1 / sqrt(conv width)
    assert float(p["conv_w"].abs().max()) > 0.45
    assert torch.all(p["conv_b"] == 0) and torch.all(p["d_skip"] == 1)
    assert torch.all(p["out_norm"] == 1)
    w = p["out_proj"]                                       # fan_in d_inner = 512
    assert abs(float(w.std()) - 512 ** -0.5) < 0.05 * 512 ** -0.5


def test_from_and_to_numpy_flat_roundtrip(smoke):
    _, _, _, flat, _ = smoke
    tree = M.from_numpy_flat(flat, device="cpu")
    back = M.to_numpy_flat(tree)
    assert list(back) == list(flat)
    for k in flat:
        assert back[k].tobytes() == flat[k].tobytes()


@pytest.mark.parametrize("arch", ARCHS)
def test_from_numpy_flat_takes_the_jax_packages_bf16_params(tmp_path, arch):
    """The JAX package's bfloat16 parameters (``ml_dtypes`` arrays), and the
    same arrays read back from an npz file (``V2``), load as bfloat16 tensors
    of the same bits; no other void dtype is taken."""
    jparams = JM.init_params(jsmoke_config(arch).with_(dtype="bfloat16"),
                             jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in jflatten(jparams).items()}
    assert any(str(a.dtype) == "bfloat16" for a in flat.values())
    np.savez(tmp_path / "p.npz", **{f"a{i}": a for i, a in enumerate(flat.values())})
    with np.load(tmp_path / "p.npz") as z:
        from_npz = {k: z[f"a{i}"] for i, k in enumerate(flat)}
    for source in (flat, from_npz):
        got = flatten_tree(M.from_numpy_flat(source, device="cpu"))
        assert list(got) == list(flat)
        for k, a in flat.items():
            t = got[k].detach()
            if str(a.dtype) == "bfloat16":
                assert t.dtype == torch.bfloat16 and got[k].requires_grad
                assert t.view(torch.int16).numpy().tobytes() == a.tobytes(), k
            else:
                assert t.numpy().tobytes() == a.tobytes(), k
    with pytest.raises(TypeError):
        M.from_numpy_flat({"w": np.zeros(2, np.float32).view("V4")}, device="cpu")


def test_loss_and_every_gradient_match_jax(smoke):
    jcfg, cfg, jparams, flat, batch = smoke
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jbatch), has_aux=True)(jparams)
    params = M.from_numpy_flat(flat, device="cpu")
    # tokens and labels as long; an encoder-decoder's frames stay float32
    tbatch = {k: torch.from_numpy(v) if v.dtype.kind == "f" else torch.from_numpy(v).long()
              for k, v in batch.items()}
    loss, m = M.loss_fn(cfg, params, tbatch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(float(m["aux"].detach()), float(jm["aux"]), atol=2e-5, rtol=2e-5)
    assert (float(m["aux"].detach()) > 0) == (cfg.moe is not None)
    assert float(m["tokens"]) == float(jm["tokens"]) == 4 * 32 - 5
    jg = {k: np.asarray(v) for k, v in jflatten(jgrads).items()}
    tg = flatten_tree(params)
    assert list(tg) == list(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k].grad.numpy(), jg[k], atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_rope_ffn_and_xent_pieces_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 3, 16)).astype(np.float32)
    pos = np.arange(8)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        atol=2e-5, rtol=2e-5)
    h = rng.standard_normal((2, 16, 32)).astype(np.float32)
    w = rng.standard_normal((32, 256)).astype(np.float32) * 0.1
    lab = rng.integers(-1, 200, size=(2, 16)).astype(np.int32)
    ls, wt = layers.chunked_softmax_xent(torch.from_numpy(h), torch.from_numpy(w),
                                         torch.from_numpy(lab), chunk=4,
                                         valid_vocab=200)
    jls, jwt = jlayers.chunked_softmax_xent(jnp.asarray(h), jnp.asarray(w),
                                            jnp.asarray(lab), chunk=4,
                                            valid_vocab=200)
    np.testing.assert_allclose(float(ls), float(jls), atol=2e-5, rtol=2e-5)
    assert float(wt) == float(jwt)
