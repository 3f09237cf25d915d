"""The port's partition specs, logical-axis rules and shape-only inputs
against the JAX package's, on the production meshes.

The reference's specs are computed from ``jax.eval_shape`` trees on
``jax.sharding.AbstractMesh`` (16, 16) and (2, 16, 16), so no placeholder
devices are needed; the port's take the same mesh as a mapping of axis
sizes (or a ``DeviceMesh``). Everything is compared exactly: a spec is a
tuple of axis names per dim. The port's contiguous cache is laid out
differently (lanes heads first, per-row ``slots`` and ``pos``), so cache
specs are compared by named dim.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS, INPUT_SHAPES
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.configs import shape_applicable
from repro.models import model as ref_model
from repro.models import transformer as ref_tfm
from repro.sharding import annotate as ref_annotate
from repro.sharding import specs as ref_specs
from repro_torch.bridge import flatten
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import model as port_model
from repro_torch.models import transformer as tfm
from repro_torch.sharding import annotate, specs
from repro_torch.sharding.specs import P

MESHES = {
    "pod16x16": ((16, 16), ("data", "model")),
    "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
# the reference's cache leaves, by named dim (its lanes are length first)
REF_CACHE_DIMS = {
    "k": ("layer", "batch", "length", "kv_heads", "head_dim"),
    "v": ("layer", "batch", "length", "kv_heads", "head_dim"),
    "cross_k": ("layer", "batch", "length", "kv_heads", "head_dim"),
    "cross_v": ("layer", "batch", "length", "kv_heads", "head_dim"),
    "state": ("layer", "batch", "heads", "key", "value"),
    "ssm_state": ("layer", "batch", "heads", "state", "head_dim"),
    "conv_tail": ("layer", "batch", "tail", "d_inner"),
    "tm_prev": ("layer", "batch", "d_model"),
    "cm_prev": ("layer", "batch", "d_model"),
    "pos": (),
}
DECODE_SHAPES = ("decode_32k", "long_500k")


def _ref_mesh(name):
    return AbstractMesh(*MESHES[name])


def _port_mesh(name):
    return dict(zip(MESHES[name][1], MESHES[name][0]))


def _leaves(tree):
    """{"a/b": leaf} of a JAX pytree, by the reference's leaf paths."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))
    return {ref_specs._leaf_path(path): leaf for path, leaf in flat}


def _spec(x):
    return tuple(x.spec if hasattr(x, "spec") else x)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = ref_config(arch)
    return jax.eval_shape(
        lambda: ref_tfm.init_params(jax.random.PRNGKey(0), cfg))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return tfm.init_params(get_config(arch), device="meta")


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


# ------------------------------------------------------------------ params
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_params_equal_the_reference_eval_shape(arch):
    """Same leaf paths, shapes and dtypes, nothing drawn or allocated."""
    ref = _leaves(_ref_params(arch))
    port = flatten(_port_params(arch))
    assert sorted(port) == sorted(ref)
    for key, leaf in port.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(ref[key].shape), key
        assert _dtype_name(leaf.dtype) == str(np.dtype(ref[key].dtype)), key


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "tp"])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mesh, fsdp):
    ref = _leaves(ref_specs.param_specs(_ref_params(arch), _ref_mesh(mesh),
                                        fsdp=fsdp))
    port = flatten(specs.param_specs(_port_params(arch), _port_mesh(mesh),
                                     fsdp=fsdp))
    assert sorted(port) == sorted(ref)
    for key, spec in port.items():
        assert isinstance(spec, specs.PartitionSpec)
        assert tuple(spec) == _spec(ref[key]), key


@pytest.mark.parametrize("mesh", MESHES)
def test_resolve_equals_the_reference(mesh):
    """Every template of the rule table, on divisible and indivisible
    dims, with stacked leading axes, with and without the FSDP dim."""
    shapes = [(64, 64), (30, 64), (64, 30), (8, 4096, 50), (2, 64, 64, 48),
              (7,), (512, 16), (3, 32, 1024)]
    for _, tpl in specs._RULES:
        for shape in shapes:
            if len(shape) < len(tpl):
                continue
            for fsdp in (True, False):
                assert tuple(specs._resolve(tpl, shape, _port_mesh(mesh),
                                            fsdp=fsdp)) == tuple(
                    ref_specs._resolve(tpl, shape, _ref_mesh(mesh),
                                       fsdp=fsdp)), (tpl, shape, fsdp)


# ------------------------------------------------------------------ batches
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_spec_and_batch_specs_equal_the_reference(arch, mesh):
    for shape_name, shape in INPUT_SHAPES.items():
        if shape.kind == "decode":
            continue
        ref = ref_model.batch_spec(ref_config(arch), shape)
        port = port_model.batch_spec(get_config(arch), shape)
        assert sorted(port) == sorted(ref)
        for key, leaf in port.items():
            assert leaf.device.type == "meta"
            assert tuple(leaf.shape) == tuple(ref[key].shape)
            assert _dtype_name(leaf.dtype) == str(np.dtype(ref[key].dtype))
        ref_s = _leaves(ref_specs.batch_specs(ref, _ref_mesh(mesh)))
        port_s = flatten(specs.batch_specs(port, _port_mesh(mesh)))
        assert {k: tuple(v) for k, v in port_s.items()} == \
            {k: _spec(v) for k, v in ref_s.items()}, shape_name


# ------------------------------------------------------------------ caches
def _decode_cases():
    return [(arch, shape) for arch in ARCH_IDS for shape in DECODE_SHAPES
            if shape_applicable(ref_config(arch), INPUT_SHAPES[shape])]


@functools.lru_cache(maxsize=None)
def _decode_specs(arch, shape):
    return (ref_model.decode_specs(ref_config(arch), INPUT_SHAPES[shape]),
            port_model.decode_specs(get_config(arch), INPUT_SHAPES[shape]))


def _by_name(dims, shape, spec=None):
    spec = tuple(spec) if spec is not None else (None,) * len(dims)
    return {d: (n, s) for d, n, s in zip(dims, shape, spec)}


@pytest.mark.parametrize("arch,shape", _decode_cases())
def test_decode_specs_equal_the_reference_by_named_dim(arch, shape):
    (ref_cache, ref_token), (cache, token) = _decode_specs(arch, shape)
    assert tuple(token.shape) == tuple(ref_token.shape)
    assert token.dtype == torch.int32 and token.device.type == "meta"
    ref_leaves = _leaves(ref_cache)
    # the port's per-row slots and pos stand for the reference's scalar pos
    assert sorted(cache) == sorted(set(ref_leaves) | {"slots"})
    for key, leaf in cache.items():
        assert leaf.device.type == "meta"
        if key in ("slots", "pos"):
            assert tuple(leaf.shape) == (INPUT_SHAPES[shape].global_batch,)
            continue
        ref = ref_leaves[key]
        assert _by_name(specs.CACHE_DIMS[key], leaf.shape) == \
            _by_name(REF_CACHE_DIMS[key], ref.shape), key
        assert _dtype_name(leaf.dtype) == str(np.dtype(ref.dtype)), key


@pytest.mark.parametrize("kv_shard", ["heads", "seq"])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch,shape", _decode_cases())
def test_decode_cache_specs_equal_the_reference_by_named_dim(arch, shape,
                                                             mesh, kv_shard):
    (ref_cache, _), (cache, _) = _decode_specs(arch, shape)
    ref = _leaves(ref_specs.decode_cache_specs(ref_cache, _ref_mesh(mesh),
                                               kv_shard=kv_shard))
    port = flatten(specs.decode_cache_specs(cache, _port_mesh(mesh),
                                            kv_shard=kv_shard))
    batch_axes = specs.batch_axes(_port_mesh(mesh))
    rows = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    b = INPUT_SHAPES[shape].global_batch
    for key, spec in port.items():
        if key in ("slots", "pos"):    # per-row: they go with their rows
            assert tuple(spec) == ((rows,) if b % 16 == 0 else (None,))
            continue
        assert tuple(ref["pos"].spec) == ()
        assert _by_name(specs.CACHE_DIMS[key], cache[key].shape, spec) == \
            _by_name(REF_CACHE_DIMS[key], ref_cache[key].shape,
                     ref[key].spec), key


def test_decode_cache_specs_refuse_a_paged_cache():
    cache = tfm.init_cache(get_smoke_config("llama3_2_3b"), 2, 32,
                           paged=True, device="meta")
    with pytest.raises(ValueError, match="contiguous"):
        specs.decode_cache_specs(cache, _port_mesh("pod16x16"))


# ------------------------------------------------------------------ rules
@pytest.mark.parametrize("mesh", MESHES)
def test_resolve_spec_equals_the_reference_on_default_rules(mesh):
    """Every logical name of DEFAULT_RULES, dropped where indivisible or
    where an earlier dim took its axes."""
    assert annotate.DEFAULT_RULES == ref_annotate.DEFAULT_RULES
    names = list(annotate.DEFAULT_RULES) + [None, "unknown"]
    cases = []
    for a in names:
        for b in names:
            for shape in ((256, 4096), (8, 4096), (512, 24), (1, 1),
                          (4096, 64)):
                cases.append(((a, b), shape))
    cases += [(("batch", None, "heads", None), (256, 4096, 24, 128)),
              (("moe_group_dp", "expert", None, None), (512, 64, 8, 2048)),
              (("moe_group", None, None), (256, 128, 2048)),
              (("batch", None, "vocab"), (32, 1, 50257))]
    for logical, shape in cases:
        port = annotate.resolve_spec(logical, shape, _port_mesh(mesh),
                                     annotate.DEFAULT_RULES)
        ref = ref_annotate.resolve_spec(logical, shape, _ref_mesh(mesh),
                                        ref_annotate.DEFAULT_RULES)
        assert tuple(port) == tuple(ref), (logical, shape)


def test_with_sharding_is_the_identity_outside_a_rules_context():
    x = torch.randn(4, 8, 16)
    assert annotate.current_mesh_rules() is None
    assert annotate.with_sharding(x, ("batch", None, "heads")) is x
    assert annotate.gather_fsdp({"w": x})["w"] is x
    assert not annotate.splits("heads", 16)
    with annotate.logical_axis_rules(_port_mesh("pod16x16"),
                                     annotate.DEFAULT_RULES):
        assert annotate.current_mesh_rules() is not None
        # nothing resolves to an axis: a plain tensor stays as it is
        assert annotate.with_sharding(x, (None, None, None)) is x
        assert annotate.splits("heads", 32) and not annotate.splits(
            "heads", 24)
    assert annotate.current_mesh_rules() is None


def test_to_placements_orders_a_tuple_of_axes_by_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_production_mesh, \
        placeholder_world
    with placeholder_world(512):
        mesh = make_production_mesh(multi_pod=True)
        assert specs.to_placements(P(("pod", "data"), None, "model"),
                                   mesh) == (Shard(0), Shard(0), Shard(2))
        assert specs.to_placements(P(None, "data"), mesh) == (
            Replicate(), Shard(1), Replicate())
        assert specs.to_placements(P(), mesh) == (Replicate(),) * 3


def test_shard_meta_places_local_shards():
    from repro_torch.launch.mesh import make_production_mesh, \
        placeholder_world
    p = _port_params("llama3_2_3b")
    with placeholder_world(256):
        mesh = make_production_mesh()
        placed = flatten(specs.shard_meta(p, specs.param_specs(p, mesh),
                                          mesh))
        wq = placed["layers/attn/wq"]               # (L, d, H*dh)
        assert tuple(wq.shape) == tuple(p["layers"]["attn"]["wq"].shape)
        assert tuple(wq.to_local().shape) == (28, 3072 // 16, 3072 // 16)
        assert wq.to_local().device.type == "meta"


# ------------------------------------------------------------------ twins of
# tests/test_sharding_and_cost.py
def test_resolve_drops_indivisible_dims():
    mesh = {"data": 1, "model": 1}
    # all axes size 1 -> divisible, names preserved
    assert specs._resolve(("fsdp", "model"), (64, 64), mesh) == \
        P("data", "model")
    # the reference's rule on a 16-way model axis drops a 24-wide dim
    assert specs._resolve(("fsdp", "model"), (64, 24),
                          _port_mesh("pod16x16")) == P("data", None)


def test_param_specs_cover_all_leaves():
    mesh = {"data": 1, "model": 1}
    for arch in ["kimi_k2_1t_a32b", "rwkv6_7b", "hymba_1_5b",
                 "whisper_tiny"]:
        cfg = get_smoke_config(arch).replace(dtype="float32")
        shapes = tfm.init_params(cfg, device="meta")
        assert len(flatten(specs.param_specs(shapes, mesh))) == \
            len(flatten(shapes))


def test_param_specs_tp_only_drops_fsdp_axis():
    """fsdp=False (weight-resident decode) must never use 'data'."""
    for mesh in MESHES:
        cfg = get_smoke_config("command_r_35b").replace(dtype="float32")
        shapes = tfm.init_params(cfg, device="meta")
        for s in flatten(specs.param_specs(shapes, _port_mesh(mesh),
                                           fsdp=False)).values():
            flat = []
            for part in s:
                if part is None:
                    continue
                flat.extend(part if isinstance(part, tuple) else (part,))
            assert "data" not in flat and "pod" not in flat


def test_smoke_configs_meta_params_equal_the_reference():
    """The smoke configs' shape-only trees, too (every family)."""
    for arch in ARCH_IDS:
        cfg = ref_smoke(arch)
        ref = _leaves(jax.eval_shape(
            lambda: ref_tfm.init_params(jax.random.PRNGKey(0), cfg)))
        port = flatten(tfm.init_params(get_smoke_config(arch),
                                       device="meta"))
        assert {k: tuple(v.shape) for k, v in port.items()} == \
            {k: tuple(v.shape) for k, v in ref.items()}, arch
