"""The port's logical-axis sharding rules and abstract trees against the JAX
package's: ``AxisRules.spec_for`` on every parameter, optimizer and cache
leaf of every arch at its full published config, under every rule set with
and without the arch's overrides, on 1x1, 2x4, 16x16 and 2x16x16 mesh
shapes (the reference's fake-mesh pattern: ``spec_for`` reads only
``axis_names`` and ``shape``); the reference's own sharding cases mirrored;
``shard_shape`` against ``NamedSharding.shard_shape``; and the abstract
params, axes, optimizer state, cache axes and input specs, leaf by leaf."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P  # noqa: E402

import repro.launch.cells as jcells  # noqa: E402
import repro.sharding as jsh  # noqa: E402
from repro.configs import ALL_ARCHS, get_config as jget_config  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import (abstract_opt_state as j_abstract_opt,  # noqa: E402
                         opt_logical_axes as j_opt_axes)

import repro_torch.launch.cells as pcells  # noqa: E402
from repro_torch.checkpoint.reshard import flatten_tree  # noqa: E402
from repro_torch.configs import get_config, list_archs, shape_applicable  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch.mesh import (MeshShape, chips_in,  # noqa: E402
                                     make_card_mesh, make_production_mesh)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import abstract_opt_state, opt_logical_axes  # noqa: E402
from repro_torch.sharding import (RULE_SETS, AxisRules, axis_rules,  # noqa: E402
                                  can_shard, logical_to_spec,
                                  make_param_shardings, rule_axis_size,
                                  rules_for, shard_constraint, shard_shape)
from repro_torch.sharding.specs import _base_rules  # noqa: E402

ARCHS = sorted(ALL_ARCHS)
MESHES = {"1x1": (("data", "model"), (1, 1)),
          "2x4": (("data", "model"), (2, 4)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


class FakeMesh:
    """The reference's fake mesh: ``spec_for`` reads only these two."""
    def __init__(self, names, sizes):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


def _is_axes(x):
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def _jflat(tree, is_leaf=None):
    """The reference's pytree -> {'a/b/c': leaf} (axes tuples kept whole)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(p.key) for p in path): leaf for path, leaf in flat}


def _jtrees(cfg):
    """(axes, shapes) of the reference's params, opt state and cache."""
    ap = JM.abstract_params(cfg)
    ax = JM.logical_axes(cfg)
    s = JSHAPES["decode_32k"]
    cache = JM.make_cache(cfg, s.global_batch, s.seq_len, abstract=True,
                          enc_len=s.seq_len if cfg.enc_layers else 0)
    return {"params": (_jflat(ax, _is_axes), _jflat(ap)),
            "opt": (_jflat(j_opt_axes(ax), _is_axes), _jflat(j_abstract_opt(ap))),
            "cache": (_jflat(JM.cache_axes(cfg), _is_axes), _jflat(cache))}


def _ptrees(cfg):
    ap = M.abstract_params(cfg)
    ax = M.logical_axes(cfg)
    s = SHAPES["decode_32k"]
    cache = M.make_cache(cfg, s.global_batch, s.seq_len,
                         enc_len=s.seq_len if cfg.enc_layers else 0, device="meta")
    return {"params": (flatten_tree(ax), flatten_tree(ap)),
            "opt": (flatten_tree(opt_logical_axes(ax)),
                    flatten_tree(abstract_opt_state(ap))),
            "cache": (flatten_tree(M.cache_axes(cfg)), flatten_tree(cache))}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_equals_the_reference_on_every_leaf(arch, mesh_name):
    """Every rule set, with and without the arch's overrides, on every
    param, opt and cache leaf at the full config: the same spec."""
    names, sizes = MESHES[mesh_name]
    mesh = FakeMesh(names, sizes)
    jt, pt = _jtrees(jget_config(arch)), _ptrees(get_config(arch))
    n = 0
    for rname in sorted(RULE_SETS):
        for override in (False, True):
            jr = jsh.AxisRules(mesh=mesh, rules=jsh.RULE_SETS[rname]())
            pr = AxisRules(mesh=mesh, rules=RULE_SETS[rname]())
            if override:
                jr = jcells.make_rules(arch, mesh, rname)
                pr = pcells.make_rules(arch, mesh, rname)
            assert pr.rules == jr.rules
            for part in ("params", "opt", "cache"):
                (jax_axes, jshapes), (p_axes, pshapes) = jt[part], pt[part]
                assert p_axes.keys() == jax_axes.keys(), part
                for k, axes in p_axes.items():
                    shape = tuple(pshapes[k].shape)
                    assert axes == jax_axes[k] and shape == tuple(jshapes[k].shape), k
                    want = tuple(jr.spec_for(jax_axes[k], shape))
                    assert pr.spec_for(axes, shape) == want, (rname, override, k)
                    assert pr.spec_for(axes) == tuple(jr.spec_for(jax_axes[k])), k
                    n += 1
    assert n > 0


# -- the reference's tests/test_sharding.py, mirrored -------------------------

def _fake_mesh_rules(data=16, model=16):
    return AxisRules(mesh=FakeMesh(("data", "model"), (data, model)),
                     rules=_base_rules())


def test_divisible_dims_get_sharded():
    r = _fake_mesh_rules()
    assert r.spec_for(("vocab", "embed"), (64_000, 4096)) == ("model", None)


def test_indivisible_dim_falls_back_to_replication():
    r = _fake_mesh_rules()
    # 50280 % 16 != 0 -> vocab cannot shard
    assert r.spec_for(("vocab", "embed"), (50_280, 2048)) == (None, None)


def test_freed_axis_flows_to_later_dim():
    """kv_heads=4 can't shard 16-way; the qk head_dim picks up 'model'."""
    r = _fake_mesh_rules()
    assert r.spec_for(("embed", "kv_heads", "qk"), (4096, 4, 128)) == (None, None, "model")
    # but when heads CAN shard, qk must not reuse the axis
    assert r.spec_for(("embed", "heads", "qk"), (4096, 32, 128)) == (None, "model", None)


def test_tuple_axis_prefix_fallback():
    r = _fake_mesh_rules()
    r.rules["batch"] = ("pod", "data")
    r.mesh = FakeMesh(("pod", "data", "model"), (2, 16, 16))
    assert r.spec_for(("batch",), (32,)) == (("pod", "data"),)
    assert r.spec_for(("batch",), (2,)) == ("pod",)
    assert r.spec_for(("batch",), (1,)) == (None,)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("rules_name", ["tp", "tp_fsdp_sp", "decode"])
def test_rules_produce_valid_shardings_for_all_params(arch, rules_name):
    """Every param's spec divides its shape on the 16x16 mesh."""
    cfg = get_config(arch)
    r = _fake_mesh_rules()
    r.rules = RULE_SETS[rules_name]()
    ap, ax = flatten_tree(M.abstract_params(cfg)), flatten_tree(M.logical_axes(cfg))
    for k, axes in ax.items():
        spec = r.spec_for(axes, tuple(ap[k].shape))
        shard_shape(spec, tuple(ap[k].shape), r.mesh)       # raises unless it divides


def test_no_rules_is_noop():
    x = torch.ones((4, 4))
    assert shard_constraint(x, "batch", "embed") is x
    with axis_rules(rules_for("tp", make_card_mesh())):
        assert shard_constraint(x, "batch", "embed") is x


def test_rule_axis_size_and_can_shard_match_the_reference():
    mesh = FakeMesh(*MESHES["2x16x16"])
    for rname in sorted(RULE_SETS):
        with jsh.axis_rules(jsh.rules_for(rname, mesh)), \
                axis_rules(rules_for(rname, mesh)):
            for name in sorted(_base_rules()):
                assert rule_axis_size(name) == jsh.rule_axis_size(name), (rname, name)
                for n in (1, 2, 16, 24, 512):
                    assert can_shard(n, name) == jsh.can_shard(n, name)
    assert rule_axis_size("heads") == 1 and not can_shard(16, "heads")   # no rules


def test_make_param_shardings_and_logical_to_spec():
    cfg = get_config("yi-6b")
    mesh = FakeMesh(*MESHES["16x16"])
    r = rules_for("tp", mesh)
    ax, ap = M.logical_axes(cfg), M.abstract_params(cfg)
    specs = flatten_tree(make_param_shardings(r, ax, ap))
    for k, a in flatten_tree(ax).items():
        assert specs[k] == logical_to_spec(r, a, tuple(flatten_tree(ap)[k].shape))
    assert all(v is None for v in
               flatten_tree(make_param_shardings(AxisRules(), ax, ap)).values())


# -- shard_shape ---------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", ["2x4", "16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "jamba-v0.1-52b",
                                  "seamless-m4t-large-v2", "yi-6b"])
def test_shard_shape_equals_named_sharding(arch, mesh_name):
    names, sizes = MESHES[mesh_name]
    mesh = MeshShape(names, sizes)
    jmesh = AbstractMesh(sizes, names)
    pt = _ptrees(get_config(arch))
    for rname in ("tp_fsdp_sp", "decode", "decode_long"):
        r = pcells.make_rules(arch, mesh, rname)
        for part in ("params", "opt", "cache"):
            axes, shapes = pt[part]
            for k, a in axes.items():
                shape = tuple(shapes[k].shape)
                spec = r.spec_for(a, shape)
                want = NamedSharding(jmesh, P(*spec)).shard_shape(shape)
                assert shard_shape(spec, shape, mesh) == tuple(want), (rname, k)


def test_shard_shape_refuses_an_indivisible_spec():
    with pytest.raises(ValueError, match="does not divide"):
        shard_shape(("model",), (10,), MeshShape(("data", "model"), (1, 16)))


def test_mesh_shapes():
    assert make_card_mesh().shape == {"data": 1, "model": 1}
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    mp = make_production_mesh(multi_pod=True)
    assert mp.axis_names == ("pod", "data", "model") and chips_in(mp) == 512


# -- abstract trees ------------------------------------------------------------

def _dtype_name(x):
    return str(x.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_equal_the_reference(arch):
    """abstract_params, logical_axes, abstract_opt_state, opt_logical_axes,
    cache_axes and input_specs: same keys, shapes, axes and dtypes (tokens
    and labels are long in the port, int32 in the reference)."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    ap = M.abstract_params(cfg)
    assert all(t.is_meta for t in flatten_tree(ap).values())
    pairs = [
        (flatten_tree(ap), _jflat(JM.abstract_params(jcfg))),
        (flatten_tree(abstract_opt_state(ap)),
         _jflat(j_abstract_opt(JM.abstract_params(jcfg)))),
    ]
    for shape in SHAPES.values():
        if shape_applicable(cfg, shape)[0]:
            pairs.append((flatten_tree(M.input_specs(cfg, shape)),
                          _jflat(JM.input_specs(jcfg, JSHAPES[shape.name]))))
    for port, ref in pairs:
        assert port.keys() == ref.keys()
        for k, t in port.items():
            assert t.is_meta and tuple(t.shape) == tuple(ref[k].shape), k
            if k in ("tokens", "labels"):
                assert t.dtype == torch.long and str(ref[k].dtype) == "int32"
            else:
                assert _dtype_name(t) == str(ref[k].dtype), k
    for port, ref in [(M.logical_axes(cfg), JM.logical_axes(jcfg)),
                      (opt_logical_axes(M.logical_axes(cfg)),
                       j_opt_axes(JM.logical_axes(jcfg))),
                      (M.cache_axes(cfg), JM.cache_axes(jcfg))]:
        assert flatten_tree(port) == _jflat(ref, _is_axes)


def test_abstract_trees_allocate_nothing():
    """The full deepseek-v2 state and a long_500k cache as meta tensors."""
    cfg = get_config("deepseek-v2-236b")
    ap = M.abstract_params(cfg)
    n = sum(t.numel() for t in flatten_tree(ap).values())
    assert n == M.param_count(cfg)
    assert all(t.is_meta for t in flatten_tree(abstract_opt_state(ap)).values())
    spec = M.input_specs(get_config("jamba-v0.1-52b"), SHAPES["long_500k"])
    assert all(t.is_meta for t in flatten_tree(spec["cache"]).values())
    assert list_archs() == ARCHS
