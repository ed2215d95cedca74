"""``jax.tree``'s counterpart over the port's trees: nested dicts, lists
and tuples whose leaves are tensors (or anything else that is not one of
those containers).  ``None`` is an empty subtree, as in JAX.

The port keeps a model's ``blocks`` as a list of one dict per repeat; the
reference stacks each leaf along a leading ``n_repeats`` axis.
:func:`stack_blocks` and :func:`unstack_blocks` convert between the two
wherever ``blocks`` occurs in a tree (parameters, optimizer moments),
over tensors or numpy arrays."""
from __future__ import annotations

import numpy as np
import torch


def tree_leaves(tree) -> list:
    """The leaves in order: dict values in insertion order, sequences in
    index order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    if tree is None:
        return []
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn(leaf, *matching leaves of rest)`` over ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` whose leaves are ``leaves``, in
    :func:`tree_leaves`' order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _stack(per: list):
    if isinstance(per[0], dict):
        return {k: _stack([p[k] for p in per]) for k in per[0]}
    if isinstance(per[0], torch.Tensor):
        return torch.stack(per)
    return np.stack([np.asarray(p) for p in per])


def _row(tree, r: int):
    if isinstance(tree, dict):
        return {k: _row(v, r) for k, v in tree.items()}
    return tree[r].clone() if isinstance(tree, torch.Tensor) else np.array(tree[r])


def stack_blocks(tree):
    """The reference's layout: every ``blocks`` list of per-repeat dicts
    stacked along a new leading axis."""
    if isinstance(tree, dict):
        return {k: _stack([stack_blocks(b) for b in v])
                if k == "blocks" and isinstance(v, list) and v and isinstance(v[0], dict)
                else stack_blocks(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(stack_blocks(v) for v in tree)
    return tree


def unstack_blocks(tree):
    """The port's layout: every ``blocks`` dict of stacked leaves split
    along its leading axis into one dict per repeat (copies)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "blocks" and isinstance(v, dict):
                first = tree_leaves(v)[0]
                out[k] = [_row(v, r) for r in range(first.shape[0])]
            else:
                out[k] = unstack_blocks(v)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(unstack_blocks(v) for v in tree)
    return tree
