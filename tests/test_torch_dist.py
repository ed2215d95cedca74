"""The port's mesh (``repro_torch.launch.mesh``) and sharding rules
(``repro_torch.dist.sharding``) against the reference's, on the CPU.

``pick_data_axes``, ``data_axis_size``, ``_fsdp_entry``, ``param_specs``,
``batch_specs`` and ``cache_specs`` read only ``mesh.shape``, so both
packages run on stand-in meshes (1x1, 4x1, 2x2, 16x16, 2x16x16) over the
reference's abstract parameter trees (``build_model(cfg).init_shapes()``:
granite-3-2b and every other configuration, at full width, no memory) and
its input specs; the port walks the same shapes as ``meta`` tensors.
Then ``place`` (blocks in mesh order, views where the data already is,
one copy a distinct device) and the meshes' refusals where too few CUDA
devices exist.
"""
import dataclasses
import functools
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, config_for
from repro.dist import sharding as RS
from repro.models import build_model, input_specs
from repro.models.config import SHAPES
from repro.models.model_zoo import shape_supported
from repro_torch.configs import config_for as port_config_for
from repro_torch.dist import sharding as PS
from repro_torch.models import build_model as build_port_model
from repro_torch.models import model_zoo as PI
from repro_torch.launch.mesh import (Mesh, make_mesh, make_production_mesh,
                                     make_small_mesh)


class StandIn:
    """A mesh of ``.shape`` only."""

    def __init__(self, shape):
        self.shape = shape


MESHES = {
    "1x1": {"data": 1, "model": 1},
    "4x1": {"data": 4, "model": 1},
    "2x2": {"data": 2, "model": 2},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}


def _leaves(tree, is_leaf, path=()):
    """``{path: leaf}`` of a nested dict / list / tuple."""
    if is_leaf(tree):
        return {path: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, is_leaf, path + (k,)))
    return out


def _meta(tree):
    """The abstract tree's shapes as ``meta`` tensors (no memory)."""
    return jax.tree.map(lambda s: torch.empty(tuple(s.shape), device="meta"), tree)


def _same_specs(ref_tree, port_tree):
    ref = _leaves(ref_tree, lambda x: isinstance(x, jax.sharding.PartitionSpec))
    port = _leaves(port_tree, lambda x: isinstance(x, PS.PartitionSpec))
    assert ref.keys() == port.keys()
    assert ref, "no leaves"
    for k in ref:
        assert isinstance(port[k], PS.PartitionSpec)
        assert tuple(port[k]) == tuple(ref[k]), k


@functools.lru_cache(maxsize=None)
def _param_shapes(arch):
    return build_model(config_for(arch)).init_shapes()


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_pick_data_axes_and_size_equal_the_reference(mesh):
    m = StandIn(MESHES[mesh])
    assert PS.data_axis_size(m) == RS.data_axis_size(m)
    for dim in list(range(0, 70)) + [96, 128, 256, 480, 512, 1024]:
        assert PS.pick_data_axes(m, dim) == RS.pick_data_axes(m, dim), dim
        for taken in (None, 0, 1):
            shape = (dim, 64, 48)
            assert PS._fsdp_entry(m, shape, taken) == RS._fsdp_entry(m, shape, taken)
    assert PS.data_axis_size(None) == RS.data_axis_size(None) == 1


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mesh):
    m = StandIn(MESHES[mesh])
    cfg = config_for(arch)
    tree = _param_shapes(arch)
    _same_specs(RS.param_specs(tree, m, cfg), PS.param_specs(_meta(tree), m, cfg))


#: the shapes granite-3-2b supports
GRANITE_SHAPES = sorted(n for n, sh in SHAPES.items()
                        if shape_supported(config_for("granite3_2b"), sh)[0])


def _shards(spec, mesh) -> int:
    return math.prod(mesh.shape[a] for e in spec if e is not None
                     for a in (e if isinstance(e, tuple) else (e,)))


def _cache_against_the_reference(arch, shape, m, int8=False):
    """C13: the port's rule on the port's own cache (``input_specs``' meta
    tree, ``pos`` included) against the reference's on its stacked cache:
    each port leaf of repeat r gets the reference leaf's spec without the
    repeat axis, and 1/R of its bytes on one device."""
    cfg = dataclasses.replace(config_for(arch), kv_cache_int8=int8)
    ref = input_specs(cfg, shape)["cache"]
    port = PI.input_specs(dataclasses.replace(port_config_for(arch), kv_cache_int8=int8),
                          shape.name)["cache"]
    r_specs = RS.cache_specs(ref, m, cfg)
    p_specs = PS.cache_specs(port, m, cfg)
    assert p_specs["pos"] == PS.PartitionSpec() == tuple(r_specs["pos"])
    R = len(port["layers"])
    assert R == cfg.n_repeats
    ref_leaves = _leaves(ref["layers"], lambda x: hasattr(x, "shape"))
    ref_specs = _leaves(r_specs["layers"], lambda x: isinstance(x, jax.sharding.PartitionSpec))
    checked = 0
    for r, (blk, blk_specs) in enumerate(zip(port["layers"], p_specs["layers"])):
        leaves = _leaves(blk, lambda x: isinstance(x, torch.Tensor))
        specs = _leaves(blk_specs, lambda x: isinstance(x, PS.PartitionSpec))
        assert leaves.keys() == specs.keys() == ref_leaves.keys()
        for k, leaf in leaves.items():
            assert tuple(specs[k]) == tuple(ref_specs[k])[1:], (r, k)
            ref_bytes = math.prod(ref_leaves[k].shape) * np.dtype(ref_leaves[k].dtype).itemsize
            assert leaf.numel() * leaf.element_size() / _shards(specs[k], m) * R == \
                ref_bytes / _shards(ref_specs[k], m), (r, k)
            checked += 1
    assert checked


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", GRANITE_SHAPES)
def test_batch_and_cache_specs_equal_the_reference(shape, mesh):
    """granite-3-2b's input specs: a batch's leading dim, and a decode
    cache's batch and head dims on the port's own cache (C13)."""
    cfg = config_for("granite3_2b")
    sh = SHAPES[shape]
    m = StandIn(MESHES[mesh])
    sp = input_specs(cfg, sh)
    if sh.kind == "decode":
        _cache_against_the_reference("granite3_2b", sh, m)
    _same_specs(RS.batch_specs({"tokens": sp["tokens"]}, m, cfg),
                PS.batch_specs(_meta({"tokens": sp["tokens"]}), m, cfg))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_on_the_port_layout(arch, mesh):
    """C13 on every architecture, decode shape and mesh: every cache kind
    (kv, the MLA latent, the ssm conv and state, memory_kv, and the int8
    kv with its scales)."""
    m = StandIn(MESHES[mesh])
    for int8 in (False, True):
        for sh in SHAPES.values():
            if sh.kind == "decode" and shape_supported(config_for(arch), sh)[0]:
                _cache_against_the_reference(arch, sh, m, int8)


#: the leaves the port's rule splits less than the reference's splits their
#: stacked leaf: the 1-D ones (replicated, where the stacked 2-D leaf is
#: split over model and over data on its repeats), and the 2-D ones whose
#: data split is on the repeat axis (their own dims do not divide it)
REPLICATED_BY_THE_PORT = {"norm1", "norm2", "norm_x", "q_norm", "kv_norm", "gate_norm",
                          "A_log", "D", "dt_bias", "conv_w", "router"}


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_on_the_port_layout(arch, mesh):
    """``param_specs`` on the port's unstacked tree: each leaf's per-device
    bytes, summed over the repeats, equal the reference's stacked leaf's,
    but for :data:`REPLICATED_BY_THE_PORT`, whose leaves hold more."""
    m = StandIn(MESHES[mesh])
    cfg = config_for(arch)
    ref = _param_shapes(arch)
    r_specs = _leaves(RS.param_specs(ref, m, cfg),
                      lambda x: isinstance(x, jax.sharding.PartitionSpec))
    port = build_port_model(port_config_for(arch), "meta").init_shapes()
    p_specs = _leaves(PS.param_specs(port, m, cfg), lambda x: isinstance(x, PS.PartitionSpec))
    p_leaves = _leaves(port, lambda x: isinstance(x, torch.Tensor))
    replicated = set()
    for k, leaf in _leaves(ref, lambda x: hasattr(x, "shape")).items():
        ref_bytes = math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize \
            / _shards(r_specs[k], m)
        if "blocks" in k:
            i = k.index("blocks")
            mine = [p for p in p_leaves if p[:i + 1] == k[:i + 1] and p[i + 2:] == k[i + 1:]]
            assert len(mine) == leaf.shape[0]
        else:
            mine = [k]
        got = sum(p_leaves[p].numel() * p_leaves[p].element_size() / _shards(p_specs[p], m)
                  for p in mine)
        # a 1-D leaf is replicated by the rule; the reference's stacked 2-D
        # leaf is split over its own dim (model) and its repeats (data)
        split_less = "blocks" in k and (tuple(r_specs[k])[:1] not in ((), (None,))
                                        or p_leaves[mine[0]].dim() == 1)
        if split_less:
            replicated.add(k[-1])
            assert got > ref_bytes, k
        else:
            assert got == ref_bytes, k
    assert replicated <= REPLICATED_BY_THE_PORT


def test_shardings_for_and_named_shardings():
    mesh = make_small_mesh(data=4, devices=["cpu"] * 4)
    specs = {"a": PS.PartitionSpec("data"), "b": [PS.PartitionSpec()]}
    sh = PS.shardings_for(specs, mesh)
    assert sh["a"] == PS.NamedSharding(mesh, PS.PartitionSpec("data"))
    assert sh["b"][0].spec == () and sh["b"][0].mesh is mesh
    assert PS.batch_sharding(mesh, 8).spec == ("data",)
    assert PS.batch_sharding(mesh, 6) is None
    assert PS.replicated_sharding(mesh).spec == ()


# ---------------------------------------------------------------------------
# place
# ---------------------------------------------------------------------------


def test_place_splits_leading_axis_in_mesh_order():
    mesh = make_small_mesh(data=4, devices=["cpu"] * 4)
    tree = {"x": (torch.arange(8), torch.ones(8, 3)), "y": np.arange(16).reshape(8, 2)}
    blocks = PS.place(tree, PS.batch_sharding(mesh, 8))
    assert len(blocks) == 4
    for i, b in enumerate(blocks):
        assert b["x"][0].tolist() == [2 * i, 2 * i + 1]
        assert b["x"][1].shape == (2, 3)
        assert b["y"].tolist() == [[4 * i, 4 * i + 1], [4 * i + 2, 4 * i + 3]]
        # a block on the device its data already is on is a view, not a copy
        assert b["x"][0].data_ptr() == tree["x"][0][2 * i:].data_ptr()
    with pytest.raises(ValueError, match="does not split"):
        PS.place({"z": torch.arange(6)}, PS.NamedSharding(mesh, PS.PartitionSpec("data")))
    with pytest.raises(ValueError, match="leading axis"):
        PS.place(tree, PS.NamedSharding(mesh, PS.PartitionSpec(None, "data")))


def test_place_replicates_once_a_distinct_device():
    """A device named twice gets no second copy: positions 0 and 2 share
    the host tree, 1 and 3 one ``meta`` copy."""
    mesh = make_small_mesh(data=4, devices=["cpu", "meta", "cpu", "meta"])
    tree = {"t": {"c": (torch.arange(5), torch.ones(5, dtype=torch.bool))}}
    reps = PS.place(tree, PS.replicated_sharding(mesh))
    assert len(reps) == 4
    assert reps[0] is reps[2] and reps[1] is reps[3] and reps[0] is not reps[1]
    assert reps[0]["t"]["c"][0] is tree["t"]["c"][0]
    assert reps[1]["t"]["c"][0].device.type == "meta"
    blocks = PS.place({"x": torch.arange(8)}, PS.batch_sharding(mesh, 8))
    assert [b["x"].device.type for b in blocks] == ["cpu", "meta", "cpu", "meta"]
    assert blocks[2]["x"].tolist() == [4, 5]


def test_place_on_a_pod_mesh_splits_over_the_named_axes():
    """A bucket that divides ``data`` but not ``pod × data`` splits over
    ``data`` alone: one block a data position, at pod index 0."""
    devs = ["cpu", "meta"] * 4
    mesh = make_mesh((2, 4, 1), ("pod", "data", "model"), devs)
    assert PS.pick_data_axes(mesh, 4) == "data"
    assert PS.pick_data_axes(mesh, 8) == ("pod", "data")
    assert len(PS.positions(PS.batch_sharding(mesh, 4))) == 4
    assert PS.positions(PS.batch_sharding(mesh, 8)) == list(mesh.devices.reshape(-1))
    assert [str(d) for d in PS.positions(PS.batch_sharding(mesh, 4))] == \
        ["cpu", "meta", "cpu", "meta"]


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


def test_small_mesh_layout():
    mesh = make_small_mesh(data=2, model=2, devices=["cpu"] * 4)
    assert isinstance(mesh, Mesh)
    assert list(mesh.shape.items()) == [("data", 2), ("model", 2)]
    assert mesh.axis_names == ("data", "model") and mesh.devices.shape == (2, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    with pytest.raises(ValueError, match="devices for a"):
        make_small_mesh(data=4, devices=["cpu"] * 3)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_meshes_raise_where_too_few_cuda_devices_exist():
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_small_mesh(data=2)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_small_mesh()
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_production_mesh(multi_pod=True)
    # a card named explicitly must exist: never mapped onto another device
    with pytest.raises(RuntimeError):
        make_small_mesh(data=2, devices=["cpu", "cuda:1"])
