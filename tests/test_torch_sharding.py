"""Sharding rules of the port (``repro_torch.distributed.sharding``) against
the JAX package's ``repro.distributed.sharding``: parameter, cache, batch,
logits and ZeRO-1 optimizer specs equal JAX's exactly, leaf for leaf; the
constructor's three refusals; the divisibility property; local shard shapes
equal JAX's ``NamedSharding.shard_shape``; and specs as DTensor placements."""

from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax
from _hypothesis_compat import given, settings, st
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import all_archs as jax_all_archs
from repro.configs import get_arch as jax_get_arch
from repro.distributed.sharding import ShardingRules as JaxRules
from repro.models import build_model as jax_build_model
from repro_torch import tree
from repro_torch.configs import get_arch
from repro_torch.distributed.sharding import (
    P,
    ShardingRules,
    axis_size,
    named,
    placements,
    shard_bytes,
    shard_shape,
)
from repro_torch.models.model import build_model


class FakeMesh:  # tests/test_sharding_rules.py:12-15
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = [  # tests/test_sharding_rules.py:19-24
    {"data": 16, "model": 16},
    {"pod": 2, "data": 16, "model": 16},
    {"data": 4, "model": 8},
    {"data": 1, "model": 1},
]
ARCHS = sorted(jax_all_archs())
MESH_IDS = lambda m: "x".join(map(str, m.values()))


def _jax_specs(tree_, specs):
    """(path names, shape, spec tuple) of every JAX leaf."""
    flat = jax.tree_util.tree_flatten_with_path(tree_)[0]
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: hasattr(x, "index"))
    return [(tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path), tuple(leaf.shape), tuple(s))
            for (path, leaf), s in zip(flat, spec_leaves, strict=True)]


def _port_specs(tree_, specs):
    spec_leaves = tree.leaves(specs, is_leaf=lambda n: isinstance(n, tuple))
    return [(tuple(str(k) for k in path), tuple(leaf.shape), s)
            for (path, leaf), s in zip(tree.leaves_with_path(tree_), spec_leaves, strict=True)]


def _param_pair(name):
    jparams = jax.eval_shape(lambda: jax_build_model(jax_get_arch(name)).init(jax.random.key(0)))
    return jparams, build_model(get_arch(name)).init_shapes()


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("mesh_shape", MESHES, ids=MESH_IDS)
def test_param_specs_equal_jax(name, mesh_shape):
    jparams, params = _param_pair(name)
    want = _jax_specs(jparams, JaxRules(jax_get_arch(name), FakeMesh(mesh_shape)).params_specs(jparams))
    got = _port_specs(params, ShardingRules(get_arch(name), mesh_shape).params_specs(params))
    assert got == want


@pytest.mark.parametrize("name", ARCHS)
def test_cache_batch_logits_and_zero1_specs_equal_jax(name):
    mesh_shape = {"pod": 2, "data": 16, "model": 16}
    jrules = JaxRules(jax_get_arch(name), FakeMesh(mesh_shape))
    rules = ShardingRules(get_arch(name), mesh_shape)
    jcache = jax.eval_shape(lambda: jax_build_model(jax_get_arch(name)).init_cache(128, 1024))
    cache = build_model(get_arch(name)).cache_shapes(128, 1024)
    assert _port_specs(cache, rules.cache_specs(cache)) == _jax_specs(jcache, jrules.cache_specs(jcache))
    batch = {"tokens": torch.empty(64, 8, device="meta"), "patch_embeds": torch.empty(96, 4, 8, device="meta")}
    jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), jax.numpy.float32) for k, v in batch.items()}
    assert rules.batch_specs(batch) == {k: tuple(v) for k, v in jrules.batch_specs(jbatch).items()}
    for ndim in (3, 4):
        assert rules.logits_spec(ndim) == tuple(jrules.logits_spec(ndim))
    jparams, params = _param_pair(name)
    kw = dict(fsdp_axes=("data", "model"), model_axis="none", zero_stage=1)
    jz = JaxRules(jax_get_arch(name), FakeMesh({"data": 16, "model": 16}), **kw)
    z = ShardingRules(get_arch(name), {"data": 16, "model": 16}, **kw)
    assert _port_specs(params, z.params_specs(params)) == _jax_specs(jparams, jz.params_specs(jparams))
    assert _port_specs(params, z.opt_specs(params)) == _jax_specs(jparams, jz.opt_specs(jparams))


@pytest.mark.parametrize("kw,match", [
    (dict(fsdp_axes=("data", "replica")), "fsdp"),
    (dict(fsdp_axes=("data", "model"), model_axis="model"), "model"),
    (dict(fsdp_axes=("data", "data")), "repeat"),
])
def test_constructor_refusals_match_jax(kw, match):
    mesh_shape = {"data": 16, "model": 16}
    with pytest.raises(ValueError, match=match):
        ShardingRules(get_arch("rwkv6-3b"), mesh_shape, **kw)
    with pytest.raises(ValueError, match=match):
        JaxRules(jax_get_arch("rwkv6-3b"), FakeMesh(mesh_shape), **kw)


def _check_divisible(name, mesh_shape):
    params = build_model(get_arch(name)).init_shapes()
    specs = ShardingRules(get_arch(name), mesh_shape).params_specs(params)
    for path, leaf_shape, spec in _port_specs(params, specs):
        assert len(spec) <= len(leaf_shape), (path, spec, leaf_shape)
        for dim, axis in zip(leaf_shape, spec):
            assert dim % axis_size(mesh_shape, axis) == 0, (path, leaf_shape, spec)


@settings(max_examples=25, deadline=None)
@given(
    arch_name=st.sampled_from(ARCHS),
    data=st.sampled_from([1, 2, 4, 8, 16]),
    model=st.sampled_from([1, 2, 4, 8, 16, 32]),
)
def test_property_specs_divide_for_random_mesh_sizes(arch_name, data, model):
    """tests/test_sharding_rules.py:52-60 on the port, and equal to JAX's."""
    mesh_shape = {"data": data, "model": model}
    _check_divisible(arch_name, mesh_shape)
    jparams, params = _param_pair(arch_name)
    want = _jax_specs(jparams, JaxRules(jax_get_arch(arch_name), FakeMesh(mesh_shape)).params_specs(jparams))
    assert _port_specs(params, ShardingRules(get_arch(arch_name), mesh_shape).params_specs(params)) == want


def test_specs_are_partition_spec_canonical():
    """A one-axis group is its name, as PartitionSpec prints it."""
    assert P(("data",), None, ("pod", "data"), ()) == ("data", None, ("pod", "data"), None)


@pytest.mark.parametrize("name", ["granite-3-8b", "nemotron-4-340b", "zamba2-2.7b", "mixtral-8x7b"])
@pytest.mark.parametrize("mesh_shape", MESHES[:3], ids=MESH_IDS)
def test_shard_shapes_equal_jax_named_sharding(name, mesh_shape):
    """Every parameter's local shape against JAX's NamedSharding over an
    AbstractMesh of the same axes; and the bytes of the whole tree."""
    jparams, params = _param_pair(name)
    jmesh = AbstractMesh(tuple(mesh_shape.values()), tuple(mesh_shape))
    jspecs = JaxRules(jax_get_arch(name), FakeMesh(mesh_shape)).params_specs(jparams)
    specs = ShardingRules(get_arch(name), mesh_shape).params_specs(params)
    spec_leaves = tree.leaves(specs, is_leaf=lambda n: isinstance(n, tuple))
    want_bytes = 0
    for leaf, jspec, jleaf, spec in zip(tree.leaves(params), jax.tree.leaves(jspecs, is_leaf=lambda x: hasattr(x, "index")),
                                        jax.tree.leaves(jparams), spec_leaves, strict=True):
        want = NamedSharding(jmesh, jspec).shard_shape(jleaf.shape)
        assert shard_shape(spec, leaf.shape, mesh_shape) == tuple(want)
        n = 1
        for d in want:
            n *= d
        want_bytes += n * jleaf.dtype.itemsize
    assert shard_bytes(specs, params, mesh_shape) == float(want_bytes)


def test_shard_shape_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="divide"):
        shard_shape(("model",), (14, 8), {"model": 16})


def test_placements_of_specs():
    """Shard(d) on each axis of a group, major axis first; a flattened
    "pod+data" mesh dimension takes the group whole."""
    from torch.distributed.tensor import Replicate, Shard

    mesh3 = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert placements((("pod", "data"), None, "model"), mesh3) == (Shard(0), Shard(0), Shard(2))
    assert placements((None, None), mesh3) == (Replicate(),) * 3
    flat = SimpleNamespace(mesh_dim_names=("pod+data", "model"))
    assert placements(("model", ("pod", "data")), flat) == (Shard(1), Shard(0))
    with pytest.raises(ValueError, match="order"):
        placements((("data", "pod"),), mesh3)
    with pytest.raises(ValueError, match="absent"):
        placements(("data",), flat)
    specs = {"a": ("model", None), "b": {"c": (("pod", "data"),)}}
    assert named(flat, specs) == {"a": (Replicate(), Shard(0)), "b": {"c": (Shard(0), Replicate())}}
