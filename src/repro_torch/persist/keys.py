"""Port of ``src/repro/persist/keys.py``: a copy.

Stable cache-key machinery for the persistent plan tier.

A persistent cache key must mean the same thing in every process that opens
the store, so it may contain only value-like primitives: ``str``, ``bytes``,
``int``, ``float``, ``bool``, ``None`` and (nested) tuples of those.
Anything process-local — ``id()``-derived integers, monotonic stamp counters,
dict-order-dependent sequences, live objects — would make two identical
statements in two workers miss (or worse, alias) each other.

:func:`assert_stable_key` is the enforcement point: the session routes every
persistent key through it, and the round-trip test in
the reference's ``tests/test_persist.py`` asserts ``parse_key(repr(key)) == key`` for every
tier so a regression that smuggles a process-local value into a key fails
loudly instead of silently degrading hit rates.
"""
from __future__ import annotations

import ast
import hashlib
import re

_SCALARS = (str, bytes, bool, int, float, type(None))

#: the pre-PR-10 reserved slot-parameter spelling embedded the occurrence's
#: process-local ``node_id`` (``__cse_slot_<digits>``) — a value that can
#: never mean the same thing in two processes.  The canonical spelling is
#: ordinal-based (``__cse_slot_o<digits>``, see ``repro.fuse.merge``) and
#: deliberately does not match this shape.
_ID_SHAPED = re.compile(r"^__cse_slot_\d+$")


def assert_stable_key(obj: object, path: str = "key") -> None:
    """Raise ``TypeError`` naming the offending path unless *obj* is built
    purely from persistable primitives (scalars and nested tuples), none of
    which spell a process-local identity (id()-shaped slot-parameter
    names)."""
    if isinstance(obj, str):
        if _ID_SHAPED.match(obj):
            raise TypeError(
                f"unstable cache-key component at {path}: {obj!r} embeds a "
                "process-local node id — use the canonical ordinal slot "
                "spelling (repro_torch.fuse.merge.slot_param)"
            )
        return
    if isinstance(obj, _SCALARS):
        return
    if isinstance(obj, tuple):
        for i, item in enumerate(obj):
            assert_stable_key(item, f"{path}[{i}]")
        return
    raise TypeError(
        f"unstable cache-key component at {path}: {type(obj).__name__} "
        f"({obj!r}) — persistent keys may only contain "
        "str/bytes/int/float/bool/None and tuples thereof"
    )


def key_digest(key: tuple) -> str:
    """Content-addressed filename for *key* (hex sha256 of its repr)."""
    assert_stable_key(key)
    return hashlib.sha256(repr(key).encode("utf-8")).hexdigest()


def parse_key(text: str) -> tuple:
    """Inverse of ``repr`` for stable keys (strict literal parse)."""
    key = ast.literal_eval(text)
    assert_stable_key(key)
    return key
