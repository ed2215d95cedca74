"""Port of ``src/repro/dist/sharding.py``: the sharding rules for the
production meshes (16×16 single-pod, 2×16×16 multi-pod; axes
``data``/``model`` plus optional leading ``pod``), and :func:`place`, the
counterpart of ``jax.device_put`` for the placements the engine uses.

Placement policy (divisibility-gated — a dim that doesn't divide its mesh
axes is replicated, never padded):

* **Params** — tensor-parallel on the trailing feature dim over ``model``,
  FSDP on the largest remaining dim over ``(pod, data)`` (falling back to
  ``data`` alone when the pod product doesn't divide).  1-D leaves (norm
  scales, gates) are replicated.
* **Batches** — leading (batch) dim over ``(pod, data)``.
* **Decode caches** — the port's own layout (``models/transformer.py::
  init_cache``: one dict per super-block, leaves ``(batch, heads?, …)``):
  dim 0 (batch) over ``(pod, data)``; the head-like dim 1 over ``model``
  when it divides.  The reference's rule, shifted one dim left past its
  stacked-repeat axis.

All rules only read ``mesh.shape`` (a name→size mapping), so they work on
stand-in meshes for layout validation without any devices.  A tree is a
nested dict / list / tuple; a leaf is anything with a ``shape``.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch


class PartitionSpec(tuple):
    """One entry per dim: a mesh axis name, a tuple of them, or None
    (replicated along that dim); ``PartitionSpec()`` replicates the whole
    value.  A tuple, so two specs compare as their entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


class NamedSharding:
    """A placement: ``spec`` over ``mesh``."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __hash__(self):
        return hash((id(self.mesh), self.spec))

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _is_leaf(x) -> bool:
    return isinstance(x, PartitionSpec) or hasattr(x, "shape")


def _tree_map(fn, tree, is_leaf=_is_leaf):
    """``fn`` over the leaves of a nested dict / list / tuple."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v, is_leaf)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        items = [_tree_map(fn, v, is_leaf) for v in tree]
        if hasattr(tree, "_fields"):  # a namedtuple
            return type(tree)(*items)
        return type(tree)(items)
    if tree is None:
        return None
    return fn(tree)


def _axis_product(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _data_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def pick_data_axes(mesh, dim: int):
    """The PartitionSpec entry for sharding ``dim`` over the data axes:
    pod+data jointly when their product divides, data alone as fallback,
    None when neither divides.  The single divisibility-gating rule every
    data-axis placement in this package (and the engine's sharded
    ``execute_many`` batches) uses."""
    present = _data_axes(mesh)
    for axes in (present, present[-1:]):
        if not axes:
            continue
        n = _axis_product(mesh, axes)
        if n > 1 and dim % n == 0:
            return axes if len(axes) > 1 else axes[0]
    return None


def data_axis_size(mesh) -> int:
    """Number of data-parallel shards the mesh offers a batch axis (the
    product of the present data axes; 1 on a data-free or absent mesh)."""
    if mesh is None:
        return 1
    return _axis_product(mesh, _data_axes(mesh))


def batch_sharding(mesh, dim: int):
    """NamedSharding placing a leading ``dim``-sized batch axis over the
    data axes, or None when divisibility gating rejects it.  Trailing dims
    are replicated, so one spec serves every leaf of a stacked-parameter
    tree."""
    entry = pick_data_axes(mesh, dim)
    if entry is None:
        return None
    return NamedSharding(mesh, PartitionSpec(entry))


def replicated_sharding(mesh):
    """NamedSharding replicating a value on every device of ``mesh`` —
    how catalog tables broadcast under sharded batch execution."""
    return NamedSharding(mesh, PartitionSpec())


def _fsdp_entry(mesh, shape, taken: int | None):
    """(dim, spec entry) for the largest dim divisible by the data axes
    (preferring pod+data jointly), or (None, None)."""
    present = _data_axes(mesh)
    for axes in (present, present[-1:]):
        if not axes:
            continue
        n = _axis_product(mesh, axes)
        if n <= 1:
            continue
        cands = [d for d in range(len(shape))
                 if d != taken and shape[d] % n == 0 and shape[d] >= n]
        if cands:
            d = max(cands, key=lambda i: shape[i])
            return d, (axes if len(axes) > 1 else axes[0])
    return None, None


def param_specs(tree, mesh, cfg):
    """PartitionSpec per leaf: TP over ``model`` on a trailing dim, FSDP
    over ``(pod, data)`` on the largest remaining dim.

    On the port's own tree (``blocks`` a list of one dict per repeat) a
    leaf has no repeat axis, and two kinds of leaf are split less than the
    reference splits their stacked leaf: every 1-D leaf (norm scales,
    ``A_log``, ``D``, ``dt_bias``), replicated, where the stacked 2-D leaf
    is split over ``model`` on its own dim and over the data axes on its
    repeats; and the 2-D leaves whose own dims do not divide the data axes
    (Mamba's ``conv_w``, the MoE ``router``), which the reference splits
    over them on the repeats.  Those leaves are the whole of the
    per-device difference between the two layouts; every other leaf gets
    the reference's spec without the repeat axis."""
    model = mesh.shape.get("model", 1)

    def spec_for(leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd <= 1:
            return PartitionSpec()
        entries = [None] * nd
        model_dim = None
        if model > 1:
            for d in (nd - 1, nd - 2):
                if shape[d] % model == 0 and shape[d] >= model:
                    model_dim = d
                    entries[d] = "model"
                    break
        fsdp_dim, entry = _fsdp_entry(mesh, shape, model_dim)
        if fsdp_dim is not None:
            entries[fsdp_dim] = entry
        return PartitionSpec(*entries)

    return _tree_map(spec_for, tree)


def batch_specs(tree, mesh, cfg):
    """Shard the leading (batch) dim over the data(+pod) axes."""

    def spec_for(leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd == 0:
            return PartitionSpec()
        entry = pick_data_axes(mesh, shape[0])
        return PartitionSpec(entry, *(None,) * (nd - 1))

    return _tree_map(spec_for, tree)


def cache_specs(tree, mesh, cfg):
    """Specs of the port's decode cache (``init_cache``'s tree): each leaf
    (batch, heads?, …) gets batch over the data(+pod) axes and the
    head-like dim 1 over ``model`` when it divides and the leaf has at
    least 3 dims.  That is the reference's spec of its stacked leaf
    (repeats, batch, heads?, …) without the repeat axis, so a leaf's
    per-device bytes are the reference leaf's over the repeat count.
    ``pos``, a Python int, gets ``PartitionSpec()``, as the reference's
    0-d ``pos``."""
    model = mesh.shape.get("model", 1)

    def spec_for(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        nd = len(shape)
        if nd == 0:
            return PartitionSpec()
        entries = [None] * nd
        entries[0] = pick_data_axes(mesh, shape[0])
        if model > 1 and nd >= 3 and shape[1] % model == 0 and shape[1] >= model:
            entries[1] = "model"
        return PartitionSpec(*entries)

    return _tree_map(spec_for, tree)


def shardings_for(specs, mesh):
    """PartitionSpec tree -> NamedSharding tree on ``mesh``."""
    return _tree_map(lambda s: NamedSharding(mesh, s), specs,
                     is_leaf=lambda x: isinstance(x, PartitionSpec))


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def positions(sharding) -> list[torch.device]:
    """The device of each position ``sharding`` places a value at, in mesh
    order: one per block of a leading-axis split (the device at index 0
    along the axes the split does not name), or one per mesh device for a
    replicated sharding."""
    mesh, spec = sharding.mesh, sharding.spec
    if not any(e is not None for e in spec):
        return list(mesh.devices.flat)
    if any(e is not None for e in spec[1:]):
        raise ValueError(f"place splits a leading axis only, not {spec}")
    entry = spec[0]
    axes = entry if isinstance(entry, tuple) else (entry,)
    names = list(mesh.shape)
    out = []
    for idx in itertools.product(*(range(mesh.shape[a]) for a in axes)):
        at = [0] * len(names)
        for a, i in zip(axes, idx):
            at[names.index(a)] = i
        out.append(mesh.devices[tuple(at)])
    return out


def _to(leaf, device):
    if isinstance(leaf, np.ndarray):
        leaf = torch.as_tensor(leaf)
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device, non_blocking=True)
    return leaf


def _has_shape(x) -> bool:
    return hasattr(x, "shape")


def to_device(tree, device):
    """Every array leaf of ``tree`` on ``device`` (the leaf itself where it
    is there already)."""
    return _tree_map(lambda x: _to(x, device), tree, is_leaf=_has_shape)


def place(tree, sharding) -> list:
    """``tree`` laid out by ``sharding`` (``jax.device_put``'s
    counterpart): one tree per position of :func:`positions`.  A
    leading-axis split gives position ``i`` the ``i``-th contiguous block
    of every leaf's leading axis, on its device (a view where the leaf is
    already there).  A replicated sharding copies the tree once to each
    distinct device, and positions on one device share that copy: a device
    named twice in the mesh gets no second copy."""
    devs = positions(sharding)
    if not any(e is not None for e in sharding.spec):
        copies = {d: to_device(tree, d) for d in dict.fromkeys(devs)}
        return [copies[d] for d in devs]
    n = len(devs)

    def block(leaf, i, d):
        rows = leaf.shape[0]
        if rows % n:
            raise ValueError(f"leading axis {rows} does not split over {n} positions")
        b = rows // n
        return _to(leaf[i * b:(i + 1) * b], d)

    return [_tree_map(lambda x, i=i, d=d: block(x, i, d), tree, is_leaf=_has_shape)
            for i, d in enumerate(devs)]
