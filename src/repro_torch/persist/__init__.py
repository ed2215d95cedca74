"""Port of ``src/repro/persist/``: only :mod:`repro_torch.persist.keys`,
the key parser the cost router's ``import_state`` reads.  The rest of the
persistent tier (``store.py``, ``costs.py``, ``codec.py``, and the
session's ``save_costs``/``_load_costs``) is ROADMAP A9.
"""
from repro_torch.persist.keys import assert_stable_key, key_digest, parse_key

__all__ = ["assert_stable_key", "key_digest", "parse_key"]
