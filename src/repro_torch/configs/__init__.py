"""Copy of ``src/repro/configs/__init__.py`` (and of its ten arch modules,
which are plain data: the exact published configurations).

Assigned-architecture registry: one module per arch, each exposing
``config()`` (the exact published configuration) and ``smoke_config()``
(a reduced same-family config for CPU smoke tests).

Select with ``--arch <id>`` in the launchers.
"""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = [
    "mamba2_370m",
    "llama32_vision_90b",
    "jamba15_large_398b",
    "granite3_2b",
    "minicpm3_4b",
    "phi3_mini_38b",
    "gemma3_12b",
    "mixtral_8x7b",
    "granite_moe_3b_a800m",
    "seamless_m4t_large_v2",
]

# public ids (hyphenated) -> module names
ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def get_arch(name: str):
    """Return the config module for an arch id (accepts - or _ forms)."""
    mod_name = ALIASES.get(name, name).replace("-", "_")
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def config_for(name: str):
    return get_arch(name).config()


def smoke_config_for(name: str):
    return get_arch(name).smoke_config()


def all_configs():
    return {a: config_for(a) for a in ARCH_IDS}
