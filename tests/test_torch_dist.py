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
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, config_for
from repro.dist import sharding as RS
from repro.models import build_model, input_specs
from repro.models.config import SHAPES
from repro.models.model_zoo import shape_supported
from repro_torch.dist import sharding as PS
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


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", GRANITE_SHAPES)
def test_batch_and_cache_specs_equal_the_reference(shape, mesh):
    """granite-3-2b's input specs: a batch's leading dim, a decode cache's
    batch and head dims."""
    cfg = config_for("granite3_2b")
    sh = SHAPES[shape]
    m = StandIn(MESHES[mesh])
    sp = input_specs(cfg, sh)
    if sh.kind == "decode":
        _same_specs(RS.cache_specs(sp["cache"], m, cfg),
                    PS.cache_specs(_meta(sp["cache"]), m, cfg))
    _same_specs(RS.batch_specs({"tokens": sp["tokens"]}, m, cfg),
                PS.batch_specs(_meta({"tokens": sp["tokens"]}), m, cfg))


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
