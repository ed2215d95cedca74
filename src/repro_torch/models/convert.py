"""Carry parameters and training state across from the reference.

``params_from_reference(tree, cfg, device)`` takes the reference's
parameter pytree as numpy arrays (``jax.tree.map(np.asarray, params)``),
splits ``tree["blocks"]``' leading ``n_repeats`` axis into one dict per
super-block, and returns the port's :class:`Model` holding the same
values.  ``state_from_reference(state_np, cfg, device)`` does the same for
a whole reference ``TrainState`` (``{"params", "opt": {"m", "v", "step"},
"ef_error"}``) and returns the port's
:class:`~repro_torch.train.train_loop.TrainState`, and
:func:`tree_to_reference` goes the other way, stacking ``blocks``.  bf16
crosses as its bits: a ``uint16`` array (or an ``ml_dtypes`` bfloat16
one, viewed as ``uint16``) becomes a ``torch.bfloat16`` tensor, and a
bf16 tensor becomes a ``uint16`` array.  Nothing here imports JAX or
``ml_dtypes``: the trees are plain numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.model_zoo import Model
from repro_torch.tree import stack_blocks, tree_map, unstack_blocks


def array_to_tensor(arr, device=None) -> torch.Tensor:
    """A numpy array (bf16 as ``uint16`` bits or ``ml_dtypes``' bfloat16)
    as a tensor on ``device``."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        arr = arr.view(np.uint16)
    if arr.dtype == np.uint16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(arr), device=device)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy: bf16 as its ``uint16`` bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _to_port(tree, device):
    """A reference tree of numpy arrays in the port's layout, as tensors
    on ``device``."""
    return tree_map(lambda a: array_to_tensor(a, device), unstack_blocks(tree))


def params_from_reference(tree: dict, cfg: ArchConfig, device=None) -> Model:
    model = Model(cfg, device)
    return model.load(_to_port(tree, model.device))


def state_from_reference(state_np: dict, cfg: ArchConfig, device=None):
    """The reference's ``TrainState`` as numpy trees (``{"params", "opt",
    "ef_error"}``, ``opt`` holding ``m``, ``v`` and ``step``) as the
    port's ``TrainState`` on ``device`` (the card by default)."""
    from repro_torch.tables.table import resolve_device
    from repro_torch.train.train_loop import TrainState

    device = resolve_device(device)
    return TrainState(_to_port(state_np["params"], device), _to_port(state_np["opt"], device),
                      _to_port(state_np.get("ef_error"), device))


def tree_to_reference(tree):
    """A port tree as the reference lays it out, in numpy: every
    ``blocks`` list of per-repeat dicts stacked along a new leading axis,
    bf16 tensors as ``uint16`` bits."""
    return tree_map(lambda t: tensor_to_array(t) if isinstance(t, torch.Tensor)
                    else np.asarray(t), stack_blocks(tree))
