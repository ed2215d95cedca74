"""Port of ``src/repro/persist/``: the persistent plan tier.

Froid algebrizes and optimizes a UDF-bearing statement *once* so every later
invocation reuses the plan; this package extends that reuse across process
boundaries.  A :class:`PlanStore` is an on-disk (or shared-volume) cache
keyed by the same identity the in-memory session caches use — plan
fingerprint x policy fingerprint x param signature x batch bucket x fused
template tuple — plus a content-derived catalog/registry token so DDL
invalidates entries by value, not by process-local stamp.  The keys are
the reference's, value for value.

Where the reference stores a serialized XLA executable, the port stores
the optimized plan its eager program runs, pickled
(:mod:`repro_torch.persist.codec`); the cost router's measured tables
persist as JSON (:mod:`repro_torch.persist.costs`).

Guarantees, as in the reference:

* writes are atomic (temp file + ``os.replace``), so concurrent writers and
  readers never observe a partial entry;
* every entry is version-stamped (schema, torch and CUDA versions, device
  type, CUDA device count) and a stale stamp is rejected — the session
  rebuilds.  An entry of the reference's carries its JAX stamp, so it is
  rejected here silently, and the other way round;
* a truncated or corrupt entry raises a typed :class:`PlanCacheCorruptError`
  inside the store, which the session converts into a
  :class:`PlanCacheWarning` plus a silent rebuild — never wrong results,
  never a crash.
"""
from repro_torch.persist.keys import assert_stable_key, key_digest, parse_key
from repro_torch.persist.store import (
    PERSIST_SCHEMA_VERSION,
    PlanCacheCorruptError,
    PlanCacheError,
    PlanCacheVersionError,
    PlanCacheWarning,
    PlanStore,
    runtime_stamp,
)

__all__ = [
    "PERSIST_SCHEMA_VERSION",
    "PlanCacheCorruptError",
    "PlanCacheError",
    "PlanCacheVersionError",
    "PlanCacheWarning",
    "PlanStore",
    "assert_stable_key",
    "key_digest",
    "parse_key",
    "runtime_stamp",
]
