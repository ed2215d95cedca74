"""Port of ``src/repro/launch/mesh.py``: named device meshes.

A :class:`Mesh` is an array of ``torch.device`` with a name per axis, in
the reference's layouts.  Functions, not module-level constants: importing
this module touches no device.

PyTorch has no virtual devices, so where the reference runs its sharded
tier on one CPU under ``XLA_FLAGS=--xla_force_host_platform_device_count``
(eight positions over one physical device), a caller here names one
device more than once in ``devices`` (``["cpu"] * 4``, ``["cuda:0"] * 2``).
Without ``devices`` a mesh takes real CUDA devices only, and raises where
fewer exist: a missing card is never mapped onto another.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.tables.table import resolve_device


class Mesh:
    """``devices`` (a numpy object array of ``torch.device``) with one name
    per axis.  ``shape`` is the ordered name -> size mapping, all that the
    sharding rules (:mod:`repro_torch.dist.sharding`) read."""

    def __init__(self, devices, axis_names):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.shape = OrderedDict(zip(axis_names, devices.shape))

    def __repr__(self):
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes}; {[str(d) for d in self.devices.flat]})"


def _cuda_devices(n: int) -> list[torch.device]:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(
            f"a mesh of {n} devices needs {n} CUDA devices and {have} exist; "
            "name the devices explicitly (a device may be named more than "
            "once) to lay a mesh over fewer")
    return [torch.device("cuda", i) for i in range(n)]


def _resolve(d) -> torch.device:
    """An explicitly named device: a card must exist (never remapped)."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"{dev} does not exist: "
                           f"{torch.cuda.device_count()} CUDA devices")
    return dev


def make_mesh(shape, axis_names, devices=None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (default: the first
    ``prod(shape)`` CUDA devices, raising where fewer exist)."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if devices is None:
        devs = _cuda_devices(n)
    else:
        devs = [_resolve(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"{len(devs)} devices for a {shape} mesh")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 cards per pod; 2 pods = 512 cards multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_small_mesh(data: int = 1, model: int = 1, devices=None) -> Mesh:
    """A ``(data, model)`` mesh for tests and examples.  ``devices`` lists
    the ``data * model`` positions in mesh order; a device may appear more
    than once, which is this package's counterpart of the reference's
    forced host devices (several mesh positions over one physical
    device)."""
    return make_mesh((data, model), ("data", "model"), devices)
