"""Carry parameters across from the reference.

``params_from_reference(tree, cfg, device)`` takes the reference's
parameter pytree as numpy arrays (``jax.tree.map(np.asarray, params)``),
splits ``tree["blocks"]``' leading ``n_repeats`` axis into one dict per
super-block, and returns the port's :class:`Model` holding the same
values.  It imports nothing of JAX: the tree is plain numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.model_zoo import Model


def _to_torch(tree, device, index=None):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, index) for k, v in tree.items()}
    arr = np.asarray(tree)
    if index is not None:
        arr = arr[index]
    return torch.as_tensor(np.array(arr), device=device)


def params_from_reference(tree: dict, cfg: ArchConfig, device=None) -> Model:
    model = Model(cfg, device)
    params = {k: _to_torch(v, model.device) for k, v in tree.items() if k != "blocks"}
    params["blocks"] = [_to_torch(tree["blocks"], model.device, r)
                        for r in range(cfg.n_repeats)]
    return model.load(params)
