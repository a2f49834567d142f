"""The port's logical-axis sharding (``repro_torch.parallel.sharding``,
``launch.rules`` / ``specs``, ``train.train_step._zero1_spec``) against the
JAX package's, on the CPU with no process group.

The reference's ``rules_for`` and ``default_flags`` read only a mesh's
axis names and shape, and its ``_zero1_spec`` only the axis sizes, so stub
meshes stand in for both packages' meshes: the pod (16 x 16 ``('data',
'model')``), multi-pod (2 x 16 x 16 ``('pod', 'data', 'model')``) and
one-axis ``(1,) ('data',)`` meshes.  The reference's parameter axes come
from ``param_logical_axes()`` (``eval_shape``: nothing allocated); the
port's from a meta build.  Everything is compared for equality: there is
no tolerance.
"""

import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.launch.rules as ref_rules_mod
import repro.launch.specs as ref_specs
import repro.parallel.sharding as ref_sharding
import repro.train.train_step as ref_train
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import get_config as ref_config
from repro.models import build_model as ref_build
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch import rules as port_rules_mod
from repro_torch.launch import specs as port_specs
from repro_torch.models import build_model, reference_paths
from repro_torch.models.configs_runtime import RuntimeFlags
from repro_torch.parallel import sharding as port_sharding
from repro_torch.train import train_step as port_train

ARCHS = list_archs()
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model")),
          "one": ((1,), ("data",))}


def ref_mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape),
                                 shape=dict(zip(axes, shape)))


def port_mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(mesh_dim_names=axes,
                                 mesh=torch.empty(shape))


def test_logical_rules_base_is_the_reference_table():
    assert port_sharding.LOGICAL_RULES_BASE == \
        ref_sharding.LOGICAL_RULES_BASE


@pytest.mark.parametrize("fsdp", [False, True])
def test_rules_create_and_logical_to_spec(fsdp):
    for name in MESHES:
        r = ref_sharding.ShardingRules.create(ref_mesh(name), fsdp=fsdp,
                                              ep=not fsdp)
        p = port_sharding.ShardingRules.create(port_mesh(name), fsdp=fsdp,
                                               ep=not fsdp)
        assert p.rules == r.rules and p.mesh_axis_names == r.mesh_axis_names
        for logical in [("batch", None, "act_embed"),
                        ("embed", "heads", "head_dim"),
                        ("heads", "kv_heads", "mlp"),
                        ("experts", "embed", "mlp"), ("vocab", "embed"),
                        ("batch", "seq_shard", "kv_heads", None), ()]:
            assert p.spec(*logical) == tuple(r.spec(*logical))


_REF_AXES: dict = {}


def _ref_axes(arch, flags):
    """The reference's parameter axes tree (built once per arch)."""
    if arch not in _REF_AXES:
        rules = ref_sharding.ShardingRules.create(ref_mesh("one"))
        _REF_AXES[arch] = ref_build(ref_config(arch), flags,
                                    rules).param_logical_axes()
    return _REF_AXES[arch]


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_specs_equal_the_reference(arch):
    """Every parameter of the full-size arch: the port's axes are the
    reference leaf's without its leading 'layers' axis, and on every mesh
    (with the cell's rules, FSDP on and off) the port's spec equals the
    reference's ``PartitionSpec`` of the leaf, stacked axis dropped."""
    from repro.models.configs_runtime import RuntimeFlags as RefFlags
    cfg, rcfg = get_config(arch), ref_config(arch)
    model = build_model(cfg, RuntimeFlags(), device="meta")
    axes = model.param_logical_axes()
    ref_axes = _ref_axes(arch, RefFlags())
    paths = reference_paths(model)
    for name, (path, blk) in paths.items():
        want = tuple(_leaf(ref_axes, path))
        if blk is not None:
            assert want[0] == "layers", (name, want)
            want = want[1:]
        assert axes[name] == want, (name, axes[name], want)
    for mesh in MESHES:
        for fsdp in (False, True):
            rf = port_specs.default_flags(cfg, "train_4k", port_mesh(mesh))
            import dataclasses
            rf = dataclasses.replace(rf, fsdp=fsdp)
            ref_f = ref_specs.default_flags(rcfg, "train_4k", ref_mesh(mesh))
            ref_f = dataclasses.replace(ref_f, fsdp=fsdp)
            pr = port_rules_mod.rules_for(cfg, port_mesh(mesh), rf)
            rr = ref_rules_mod.rules_for(rcfg, ref_mesh(mesh), ref_f)
            for name, (path, blk) in paths.items():
                ref_spec = tuple(ref_sharding.logical_to_spec(
                    rr, _leaf(ref_axes, path)))
                if blk is not None:
                    assert ref_spec[0] is None
                    ref_spec = ref_spec[1:]
                assert port_sharding.logical_to_spec(pr, axes[name]) \
                    == ref_spec, (arch, mesh, fsdp, name)


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_equal_the_reference(arch):
    """For each of the arch's 8 cells (4 shapes x 2 meshes):
    ``shape_applicable``, ``default_flags`` (as ``asdict``), the
    ``rules_for`` table, and ``input_specs``' shapes and dtypes; for the
    decode cells ``cache_logical_axes`` leaf by leaf (the reference's
    stacked leaves carry one more leading ``None``)."""
    import dataclasses
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert list(SHAPES) == list(REF_SHAPES)
    meta = build_model(cfg, RuntimeFlags(), device="meta")
    rules = ref_sharding.ShardingRules.create(ref_mesh("one"))
    for shape in SHAPES:
        assert port_specs.shape_applicable(cfg, shape) == \
            ref_specs.shape_applicable(rcfg, shape)
        for mesh in ("pod", "multipod"):
            pf = port_specs.default_flags(cfg, shape, port_mesh(mesh))
            rf = ref_specs.default_flags(rcfg, shape, ref_mesh(mesh))
            assert dataclasses.asdict(pf) == dataclasses.asdict(rf)
            pr = port_rules_mod.rules_for(cfg, port_mesh(mesh), pf)
            rr = ref_rules_mod.rules_for(rcfg, ref_mesh(mesh), rf)
            assert pr.rules == rr.rules
            assert pr.mesh_axis_names == rr.mesh_axis_names
        ps = port_specs.input_specs(cfg, shape)
        rs = ref_specs.input_specs(rcfg, shape)
        assert set(ps) == set(rs)
        for k in rs:
            assert tuple(ps[k].shape) == tuple(rs[k].shape), (shape, k)
            assert _dtype_name(ps[k]) == str(rs[k].dtype), (shape, k)
            assert ps[k].is_meta
        seq, batch, kind = SHAPES[shape]
        if kind != "decode" or not port_specs.shape_applicable(
                cfg, shape)[0]:
            continue
        port_axes = port_rules_mod.cache_logical_axes(
            meta.init_cache(batch, seq))
        ref_model = ref_build(rcfg, ref_specs.default_flags(rcfg, shape),
                              rules)
        ref_axes = ref_rules_mod.cache_logical_axes(jax.eval_shape(
            lambda: ref_model.init_cache(batch, seq)))
        want = {}
        for path, ax in jax.tree_util.tree_flatten_with_path(
                ref_axes, is_leaf=lambda a: isinstance(a, tuple))[0]:
            want.setdefault(path[-1].key, set()).add(ax)
        for layer in port_axes:
            for k, ax in layer["mixer"].items():
                pad = {a[:len(a) - len(ax)] for a in want[k]}
                assert {a[len(a) - len(ax):] for a in want[k]} == {ax}, k
                assert all(all(x is None for x in p) for p in pad), k


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "mixtral-8x7b",
                                  "gemma3-4b", "whisper-large-v3"])
def test_zero1_spec_equals_the_reference(arch):
    """ZeRO-1's moment spec of every parameter on the pod and multi-pod
    meshes, FSDP off and on."""
    cfg = get_config(arch)
    model = build_model(cfg, RuntimeFlags(), device="meta")
    axes = model.param_logical_axes()
    for mesh in ("pod", "multipod"):
        data_axes = tuple(a for a in ("pod", "data")
                          if a in MESHES[mesh][1])
        for fsdp in (False, True):
            rules = port_sharding.ShardingRules.create(port_mesh(mesh),
                                                       fsdp=fsdp)
            for name, p in model.named_parameters():
                spec = port_sharding.logical_to_spec(rules, axes[name])
                got = port_train._zero1_spec(spec, tuple(p.shape),
                                             port_mesh(mesh), data_axes)
                want = ref_train._zero1_spec(P(*spec), tuple(p.shape),
                                             ref_mesh(mesh), data_axes)
                assert got == tuple(want), (mesh, fsdp, name)


def test_meta_build_allocates_nothing():
    """A full-size model on the meta device: no generator, no storage."""
    model = build_model(get_config("llama4-maverick-400b-a17b"),
                        RuntimeFlags(), device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n > 3e11
    assert all(p.is_meta for p in model.parameters())
