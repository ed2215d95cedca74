"""Activation batch-sharding context: a port of
``src/repro/dist/activations.py``.

The reference pins the batch axis of an activation to the ``data`` (and
``pod``) mesh axes with ``with_sharding_constraint`` at the super-block
boundaries.  Here a tensor of one process lives on one device, so
:func:`shard_batch` is the identity whether or not a mesh is installed;
data-parallel training over several cards is ROADMAP A16.3.  The mesh
context is kept so that launchers and tests set and read it as in the
reference.
"""
from __future__ import annotations

_ACTIVATION_MESH = None


def set_activation_mesh(mesh) -> None:
    """Install ``mesh`` as the activation-sharding context."""
    global _ACTIVATION_MESH
    _ACTIVATION_MESH = mesh


def clear_activation_mesh() -> None:
    global _ACTIVATION_MESH
    _ACTIVATION_MESH = None


def current_activation_mesh():
    return _ACTIVATION_MESH


def shard_batch(x):
    """The identity: one process's tensor lives on one device (the
    reference's constraint has nothing to constrain here)."""
    return x
