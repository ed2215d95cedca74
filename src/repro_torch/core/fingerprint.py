"""Port of ``src/repro/core/fingerprint.py:1-159``:
a copy with numpy dtype tags.

Structural plan fingerprints — the engine's cache-key vocabulary.

Identity-free normalization of plan trees and scalar expressions into
hashable tuples.  Every cache tier keys off these: the session's plan /
executable / batch / shard / fuse caches, the reference's persistent
plan store and its cross-statement CSE engine's unification test
(``repro/fuse/merge.py``).

Lives below both :mod:`repro_torch.core.optimizer` and
:mod:`repro_torch.core.session` in the import graph, so optimizer rewrites
(decorrelation's shared-build dedup) can fingerprint subtrees without a
cycle through the session.  ``session`` re-exports every public name for
backward compatibility.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import numpy as np

from repro_torch.core import relalg as R
from repro_torch.core import scalar as S

__all__ = [
    "plan_fingerprint",
    "parametric_fingerprint",
    "liftable_const",
    "const_hole_key",
]


def _norm(v, special=None) -> Any:
    """Normalize an attribute value into a hashable structure.

    ``special(v) -> tuple | None`` pre-empts the default rules when it
    returns non-None — :func:`parametric_fingerprint` uses it to replace
    parameter/outer references with canonical slot holes while sharing the
    rest of the structural normalization."""
    if special is not None:
        out = special(v)
        if out is not None:
            return out
    if isinstance(v, S.Scalar):
        return _expr_key(v, special)
    if isinstance(v, R.RelNode):
        return ("Rel:" + type(v).__name__,) + tuple(
            (k, _norm(x, special)) for k, x in vars(v).items() if k != "node_id"
        )
    if isinstance(v, dict):
        return ("dict",) + tuple((k, _norm(x, special)) for k, x in v.items())
    if isinstance(v, (list, tuple)):
        return ("seq",) + tuple(_norm(x, special) for x in v)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,) + tuple(
            (f.name, _norm(getattr(v, f.name), special))
            for f in dataclasses.fields(v)
        )
    if isinstance(v, (str, int, float, bool, type(None))):
        return v
    if hasattr(v, "shape") and hasattr(v, "dtype"):
        # array-valued constants: content digest, never repr (repr elides
        # the middle of large arrays, collapsing distinct values)
        arr = np.asarray(v)
        return ("array", str(arr.dtype), arr.shape,
                hashlib.sha1(arr.tobytes()).hexdigest())
    return repr(v)


def _expr_key(e: S.Scalar, special=None) -> tuple:
    return (type(e).__name__,) + tuple(
        (k, _norm(v, special)) for k, v in vars(e).items()
    )


def plan_fingerprint(node: R.RelNode) -> tuple:
    """Identity-free structural fingerprint of a plan/query tree: two
    independently-built trees of the same shape fingerprint equal."""
    return _norm(node)


def liftable_const(v) -> bool:
    """True when a :class:`~repro_torch.core.scalar.Const` may be *lifted* into a
    template hole: re-injecting its value as a parameter binding reproduces
    the constant's evaluation exactly.  int consts always evaluate int32
    (matching ``_param_value``); float consts match only at the default
    float32 dtype.  bool/str/NULL consts are structural (predication flags,
    typed nulls, dictionary literals) and never lift."""
    if not isinstance(v, S.Const):
        return False
    if isinstance(v.value, bool) or v.value is None:
        return False
    if isinstance(v.value, (int, np.integer)):
        return True
    if isinstance(v.value, (float, np.floating)):
        return v.dtype is None or v.dtype == np.float32
    return False


def const_hole_key(value) -> tuple:
    """Dtype-aware hole-numbering key of a liftable const's value (``5``
    and ``5.0`` hash equal as plain dict keys but evaluate int32 vs
    float32, so they must stay distinct holes)."""
    if isinstance(value, (int, np.integer)):
        return ("int", int(value))
    return ("float", float(value))


def parametric_fingerprint(node: R.RelNode,
                           lift_consts: bool = False) -> tuple[tuple, tuple]:
    """``(fingerprint, holes)`` with parameter slots canonicalized.

    The fingerprint is :func:`plan_fingerprint` with every ``Param``/``Outer``
    reference replaced by a numbered hole in first-encounter order, so two
    subtrees equal *modulo parameter naming* fingerprint equal — the
    unification test of the cross-statement CSE engine (``repro/fuse/merge.py``).
    Hole numbering is per-name: ``Param(a) + Param(a)`` canonicalizes to
    ``hole0 + hole0`` and therefore never unifies with ``Param(x) +
    Param(y)`` (``hole0 + hole1``); param and outer references are distinct
    hole kinds and never unify with each other.

    With ``lift_consts=True``, :func:`liftable_const` constants additionally
    become holes, and param/const holes share one hole tag — ``a < 5``
    fingerprints equal to ``a < Param(x)``, the const-vs-param unification
    key (numbering stays per-key: ``5 + 5`` is ``hole0 + hole0`` like
    ``Param(a) + Param(a)``).  The lifted fingerprint lives in its own
    namespace (tags differ from the plain form), so callers never mix the
    two key spaces.

    ``holes`` is the tuple of ``(kind, actual_name_or_value)`` in canonical
    order — the subtree's slot signature, which callers combine with the
    canonical hole spelling (``merge.hole_name``) to build per-occurrence
    binding maps.  A hole-free subtree fingerprints identically to its
    plain :func:`plan_fingerprint`."""
    holes: list[tuple[str, Any]] = []
    index: dict[tuple[str, Any], int] = {}

    def special(v):
        if isinstance(v, S.Param):
            kind, name = "param", v.name
        elif isinstance(v, S.Outer):
            kind, name = "outer", v.name
        elif lift_consts and liftable_const(v):
            # dtype-aware key: int 5 and float 5.0 compare equal as dict
            # keys, but evaluate at different dtypes — they must number as
            # distinct holes within one subtree
            kind, name = "const", const_hole_key(v.value)
        else:
            return None
        k = (kind, name)
        if k not in index:
            index[k] = len(holes)
            holes.append(k)
        tag = "lifted" if (lift_consts and kind != "outer") else kind
        return ("hole", tag, index[k])

    return _norm(node, special), tuple(holes)
