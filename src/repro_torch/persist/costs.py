"""Port of ``src/repro/persist/costs.py``: a copy over the port's store.

Cost-router persistence: measured wave-cost EMAs as store entries.

The cost router learns per-wave costs online; persisting its measured
tables lets a fresh worker route warm — no re-exploration of policy/bucket/
fuse arms it has already paid for elsewhere.  The entry is JSON (no pickled
code): rows of ``[repr(key), wave_s, n, last_s, meta]`` produced by
``CostRouter.export_state`` and re-parsed with the same strict stable-key
parser the plan tier uses.

Fault-window exclusion is inherited, not re-implemented: samples observed
under ``CostRouter.suppress`` never reach the measured tables in the first
place, so a save cannot leak degraded-wave costs no matter when it runs.

Costs are keyed by the session's content-derived environment token only —
they are advisory (routing hints), so one table serves every policy and
statement population under a given catalog/registry state.
"""
from __future__ import annotations

import json

from repro_torch.persist.store import PlanCacheCorruptError, PlanStore

#: bump on incompatible changes to the cost-row layout
COSTS_SCHEMA_VERSION = 1


def costs_key(env_token: tuple) -> tuple:
    return ("repro-costs", COSTS_SCHEMA_VERSION, env_token)


def save_costs(store: PlanStore, env_token: tuple, router) -> bool:
    """Write the router's measured tables; returns False for an empty model
    (nothing worth persisting — avoids clobbering a populated entry)."""
    state = router.export_state()
    if not state["measured"] and not state["per_ticket"]:
        return False
    blob = json.dumps(state, sort_keys=True).encode("utf-8")
    store.put(costs_key(env_token), {"kind": "costs"}, blob)
    return True


def load_costs(store: PlanStore, env_token: tuple, router, *,
               replace: bool = False) -> int:
    """Warm-start ``router`` from the store; returns records adopted (0 on
    a clean miss).  Raises the store's typed errors on stale/corrupt
    entries — callers degrade to an empty model."""
    got = store.get(costs_key(env_token))
    if got is None:
        return 0
    _meta, blob = got
    try:
        state = json.loads(blob.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise PlanCacheCorruptError(f"undecodable cost table: {e}") from e
    return router.import_state(state, replace=replace)
