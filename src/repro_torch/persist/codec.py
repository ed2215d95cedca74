"""The port's codec for the persistent plan tier (the reference's is
``src/repro/persist/codec.py``).

The reference's blob is a serialized XLA executable: a warm load skips its
trace and compile.  The port compiles nothing — a plan runs as an eager
closure over the optimized plan — so its blob is **the optimized plan**,
pickled: the thing the eager program is made of.  :func:`pack_plan` and
:func:`load_plan` take the place of ``pack_compiled``/``load_compiled``; a
fused wave's entry is the tuple of its member plans.

A pickle carries two process-local numbers that must not survive into the
reading process: every plan node's ``node_id`` (from this module's
per-process counter in :mod:`repro_torch.core.relalg`; the executor's
memo and the merge pass's sharing maps key on it) and the
``_session_stamp`` that :func:`repro_torch.core.session._stamp` hangs on
plans and UDF definitions (the fusion merge cache and the handles' warm
flags key on it).  In the reading process either would name some other
object, so :func:`load_plan` drops every ``_session_stamp`` and gives
every node a fresh ``node_id`` from this process's counter, in the order
of the old ones.  Content-derived caches (``_content_digest``) mean the
same thing everywhere and stay.

Unpickling runs code: a store is read only by the program that writes it
(its entries are stamped, and integrity-checked by
:class:`~repro_torch.persist.store.PlanStore`).

Host-side row metadata (dictionary-encoded output vocabularies, the first
run's stats) travels in the JSON entry header via :func:`encode_dicts` /
:func:`decode_dicts` and :func:`jsonable_stats`, copies of the reference's.
"""
from __future__ import annotations

import pickle
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core import relalg as R
from repro_torch.tables.table import DictEncoding

#: leaves of a plan's object graph that hold no plan node or stamp
_LEAVES = (str, bytes, int, float, bool, type(None), type, np.ndarray, np.generic,
           torch.Tensor, torch.dtype, torch.device)


def pack_plan(plan) -> bytes:
    """A plan (or a tuple of plans: a fused wave's members) as bytes."""
    return pickle.dumps(plan, protocol=pickle.HIGHEST_PROTOCOL)


def _objects(root) -> list:
    """Every object with attributes reachable from ``root`` (each once)."""
    seen: set[int] = set()
    out = []
    stack = [root]
    while stack:
        o = stack.pop()
        if isinstance(o, _LEAVES) or id(o) in seen:
            continue
        seen.add(id(o))
        if isinstance(o, (list, tuple, set, frozenset)):
            stack.extend(o)
        elif isinstance(o, dict):
            stack.extend(o.keys())
            stack.extend(o.values())
        else:
            attrs = getattr(o, "__dict__", None)
            if attrs is not None:
                out.append(o)
                stack.extend(attrs.values())
    return out


def load_plan(blob: bytes):
    """Inverse of :func:`pack_plan`, with fresh ``node_id``s (in the order
    of the writer's) and no ``_session_stamp`` anywhere in the result."""
    plan = pickle.loads(blob)
    objs = _objects(plan)
    for o in objs:
        if "_session_stamp" in o.__dict__:
            object.__delattr__(o, "_session_stamp")  # frozen dataclasses too
    nodes = sorted((o for o in objs if isinstance(o, R.RelNode)),
                   key=lambda n: n.node_id)
    for n in nodes:
        R.RelNode.__init__(n)  # the next id of this process's counter
    return plan


def encode_dicts(out_dicts: Mapping[str, DictEncoding | None] | None) -> dict | None:
    """Output dictionaries -> JSON-safe ``{column: vocab-list-or-None}``."""
    if out_dicts is None:
        return None
    return {
        name: (list(enc.vocab) if enc is not None else None)
        for name, enc in out_dicts.items()
    }


def decode_dicts(encoded: Mapping[str, list | None] | None) -> dict | None:
    """Inverse of :func:`encode_dicts`."""
    if encoded is None:
        return None
    return {
        name: (DictEncoding(vocab) if vocab is not None else None)
        for name, vocab in encoded.items()
    }


def jsonable_stats(stats: Mapping[str, Any] | None) -> dict:
    """Copy a run's stats, keeping only JSON-representable scalars."""
    out = {}
    for k, v in (stats or {}).items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        elif isinstance(v, (list, tuple)):
            out[k] = [x for x in v if isinstance(x, (str, int, float, bool))]
    return out
