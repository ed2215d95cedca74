"""Port of ``src/repro/persist/store.py``: a copy, with the runtime stamp
built from torch instead of JAX.

On-disk plan store: atomic, version-stamped, corruption-typed.

Entry layout (one file per key, named ``<sha256(key)>.plan``)::

    MAGIC (8 bytes)  b"RPRPLAN\\x01"
    u32              header length (little-endian)
    header           UTF-8 JSON: {"stamp": .., "key": repr(key),
                                  "meta": .., "blob_len": .., "blob_sha256": ..}
    blob             opaque payload (pickled optimized plan, cost table, ...)

Integrity is end-to-end: the header carries the blob's length and sha256, so
truncation or bit-rot anywhere in the file surfaces as a typed
:class:`PlanCacheCorruptError` — callers degrade to recompile, never consume
a partial plan.  Writes go through a temp file in the same directory followed
by ``os.replace``, so a reader can never observe a half-written entry and the
last concurrent writer wins cleanly.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import tempfile
from pathlib import Path

from repro_torch.persist.keys import assert_stable_key, key_digest

#: Bump on any incompatible change to entry payloads or key layout; old
#: entries are then rejected (recompile) instead of misread.
PERSIST_SCHEMA_VERSION = 1

_MAGIC = b"RPRPLAN\x01"
_LEN = struct.Struct("<I")


class PlanCacheError(Exception):
    """Base class for persistent plan-tier failures."""


class PlanCacheCorruptError(PlanCacheError):
    """Entry bytes are damaged (bad magic, truncation, digest mismatch)."""


class PlanCacheVersionError(PlanCacheError):
    """Entry was written under an incompatible runtime/schema stamp."""


class PlanCacheWarning(UserWarning):
    """Emitted when a session degrades to recompile after a bad entry."""


def runtime_stamp(device=None) -> dict:
    """The compatibility stamp embedded in (and checked against) every entry.

    An entry's blob is a pickled plan of this package, run by the torch
    build that reads it on ``device`` (``None`` means the card, and raises
    where CUDA is absent, as every entry point of the port does): the
    torch and CUDA versions, the device's type and the CUDA device count
    take the place of the reference's jax/jaxlib/backend/device count.
    Nothing in it changes between runs on one machine, and it never equals
    a stamp the reference wrote, so either package rejects the other's
    entries as stale.
    """
    import torch

    from repro_torch.tables.table import resolve_device

    platform = resolve_device(device).type
    return {
        "schema": PERSIST_SCHEMA_VERSION,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "platform": platform,
        "devices": torch.cuda.device_count() if platform == "cuda" else 0,
    }


class PlanStore:
    """A directory of version-stamped, atomically-written cache entries.

    The store is deliberately dumb: it maps stable keys to ``(meta, blob)``
    pairs and enforces integrity/compatibility.  What the blob *means* (a
    pickled plan, a cost table) is the caller's business — see
    ``repro_torch/persist/codec.py`` and ``repro_torch/persist/costs.py``.
    Without ``stamp`` the entries are stamped for ``device``
    (:func:`runtime_stamp`).
    """

    def __init__(self, root: str | os.PathLike, *, stamp: dict | None = None,
                 max_bytes: int | None = None, device=None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._stamp = dict(stamp) if stamp is not None else runtime_stamp(device)
        #: byte budget for the whole directory (None = unbounded, the
        #: historical behavior).  Every ``put`` sweeps back under budget by
        #: evicting least-recently-*used* entries — ``get`` touches an
        #: entry's mtime on a hit, so recency means reads, not just writes.
        self.max_bytes = max_bytes
        self.eviction_stats = {"evictions": 0, "evicted_bytes": 0, "sweeps": 0}

    # -- paths ------------------------------------------------------------
    def path_for(self, key: tuple) -> Path:
        return self.root / f"{key_digest(key)}.plan"

    # -- io ---------------------------------------------------------------
    def put(self, key: tuple, meta: dict, blob: bytes) -> Path:
        """Atomically write an entry (last concurrent writer wins)."""
        assert_stable_key(key)
        header = json.dumps(
            {
                "stamp": self._stamp,
                "key": repr(key),
                "meta": meta,
                "blob_len": len(blob),
                "blob_sha256": hashlib.sha256(blob).hexdigest(),
            },
            sort_keys=True,
        ).encode("utf-8")
        path = self.path_for(key)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(_MAGIC)
                f.write(_LEN.pack(len(header)))
                f.write(header)
                f.write(blob)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._sweep(keep=path)
        return path

    def get(self, key: tuple) -> tuple[dict, bytes] | None:
        """Return ``(meta, blob)``, or ``None`` on a clean miss.

        Raises :class:`PlanCacheVersionError` on a stamp mismatch and
        :class:`PlanCacheCorruptError` on any structural damage.
        """
        path = self.path_for(key)
        try:
            raw = path.read_bytes()
        except FileNotFoundError:
            return None
        except OSError as e:
            raise PlanCacheCorruptError(f"unreadable entry {path.name}: {e}") from e
        if len(raw) < len(_MAGIC) + _LEN.size or raw[: len(_MAGIC)] != _MAGIC:
            raise PlanCacheCorruptError(f"bad magic in entry {path.name}")
        (hlen,) = _LEN.unpack_from(raw, len(_MAGIC))
        hstart = len(_MAGIC) + _LEN.size
        if len(raw) < hstart + hlen:
            raise PlanCacheCorruptError(f"truncated header in entry {path.name}")
        try:
            header = json.loads(raw[hstart : hstart + hlen].decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise PlanCacheCorruptError(
                f"undecodable header in entry {path.name}: {e}"
            ) from e
        blob = raw[hstart + hlen :]
        if len(blob) != header.get("blob_len"):
            raise PlanCacheCorruptError(
                f"truncated blob in entry {path.name}: "
                f"{len(blob)} bytes != {header.get('blob_len')} expected"
            )
        if hashlib.sha256(blob).hexdigest() != header.get("blob_sha256"):
            raise PlanCacheCorruptError(f"blob digest mismatch in entry {path.name}")
        if header.get("stamp") != self._stamp:
            raise PlanCacheVersionError(
                f"entry {path.name} written under stamp {header.get('stamp')}, "
                f"this runtime is {self._stamp}"
            )
        try:
            os.utime(path)  # LRU recency: a hit protects the entry
        except OSError:
            pass
        return header.get("meta", {}), blob

    def delete(self, key: tuple) -> bool:
        try:
            self.path_for(key).unlink()
            return True
        except OSError:
            return False

    # -- eviction ----------------------------------------------------------
    def sweep(self) -> int:
        """Evict least-recently-used entries until the directory fits
        ``max_bytes`` (no-op when unbudgeted).  Returns the entries
        removed.

        Collection is a plain ``unlink`` per victim — atomic at the
        filesystem level, so a concurrent reader either opened the file
        first (and reads the intact inode to the end) or opens after and
        sees a clean miss.  A reader that does catch a torn view on a
        non-POSIX filesystem gets the store's typed
        :class:`PlanCacheCorruptError` and degrades to recompile — the
        same contract as every other store failure; eviction can never
        produce a wrong result, only a miss."""
        return self._sweep()

    def _sweep(self, keep: Path | None = None) -> int:
        if not self.max_bytes:
            return 0
        entries = []
        for p in self.root.glob("*.plan"):
            try:
                st = p.stat()
            except OSError:
                continue  # already collected by a concurrent sweep
            entries.append((st.st_mtime, st.st_size, p))
        total = sum(size for _, size, _ in entries)
        if total <= self.max_bytes:
            return 0
        self.eviction_stats["sweeps"] += 1
        evicted = 0
        for _, size, p in sorted(entries, key=lambda e: (e[0], e[2].name)):
            if total <= self.max_bytes:
                break
            if keep is not None and p == keep:
                continue  # never evict the entry this put just wrote
            try:
                p.unlink()
            except OSError:
                continue  # lost the race to another worker's sweep
            total -= size
            evicted += 1
            self.eviction_stats["evictions"] += 1
            self.eviction_stats["evicted_bytes"] += size
        return evicted

    # -- introspection ----------------------------------------------------
    def entries(self) -> list[Path]:
        return sorted(self.root.glob("*.plan"))

    def nbytes(self) -> int:
        return sum(p.stat().st_size for p in self.entries())

    def stats(self) -> dict:
        entries = self.entries()
        return {
            "root": str(self.root),
            "entries": len(entries),
            "nbytes": sum(p.stat().st_size for p in entries),
            "max_bytes": self.max_bytes,
            **self.eviction_stats,
        }
