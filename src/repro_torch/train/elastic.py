"""Elastic scaling: a port of ``src/repro/train/elastic.py`` — re-mesh and
re-shard after node count changes.

On failure/scale events the job restarts from the newest checkpoint with a
different device count.  Policy: the ``model`` axis is fixed by the
architecture's TP layout, so elasticity happens on the ``data``(+``pod``)
axes — the new data-parallel degree is ``devices // model_axis``.  State
re-sharding is value-level: checkpoints store unsharded global leaves, so
restoring onto the new mesh is placing them with the same rules
(:func:`repro_torch.dist.sharding.param_specs`) on the new mesh.  A tensor
of one process lives on one device, so a mesh whose positions name one
device (``["cpu"] * 4``, one card) takes the whole tree there; a mesh
over several distinct devices is multi-card training, ROADMAP A16.3.
"""
from __future__ import annotations

import dataclasses

from repro_torch.dist.sharding import param_specs, to_device
from repro_torch.launch.mesh import Mesh, make_mesh


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]

    def build(self, devices=None) -> Mesh:
        """The port's mesh of this plan over the first ``prod(shape)`` of
        ``devices`` (the CUDA devices by default)."""
        n = 1
        for s in self.shape:
            n *= s
        return make_mesh(self.shape, self.axes,
                         None if devices is None else list(devices)[:n])


def plan_remesh(n_devices: int, model_axis: int, pods: int = 1) -> MeshPlan:
    """Largest usable mesh for ``n_devices`` keeping the TP degree.

    Drops stragglers that don't fill a full data row; raises if fewer than
    one model group survives."""
    per_pod = n_devices // pods
    data = per_pod // model_axis
    if data < 1:
        raise ValueError(
            f"{n_devices} devices cannot host model_axis={model_axis}"
        )
    if pods > 1:
        return MeshPlan((pods, data, model_axis), ("pod", "data", "model"))
    return MeshPlan((data, model_axis), ("data", "model"))


def usable_devices(n_devices: int, model_axis: int, pods: int = 1) -> int:
    plan = plan_remesh(n_devices, model_axis, pods)
    n = 1
    for s in plan.shape:
        n *= s
    return n


def reshard_state(state_tree, mesh: Mesh, cfg):
    """Place a (restored, host-global) state tree onto ``mesh`` with the
    standard sharding rules — the elastic-restart hot path.  Every
    position of ``mesh`` must name one device, which receives the whole
    tree."""
    param_specs(state_tree, mesh, cfg)  # the rules hold on the new layout
    devices = {str(d): d for d in mesh.devices.flat}
    if len(devices) != 1:
        raise NotImplementedError(
            f"resharding over {len(devices)} distinct devices is training over "
            "several cards: ROADMAP A16.3")
    return to_device(state_tree, next(iter(devices.values())))
