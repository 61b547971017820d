"""Config registry: ``get_config(name)`` / ``get_smoke_config(name)``.

Counterpart of ``repro.configs``: the same twelve architectures in the same
order.  ASSIGNED_ARCHS are the 10 assigned architectures; CORPUS_ARCHS adds
the two paper-corpus stand-ins used by the §7.2 dedup experiments.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (
    SHAPES, MLAConfig, ModelConfig, ShapeSpec, model_config_taint_values)

__all__ = ["SHAPES", "MLAConfig", "ModelConfig", "ShapeSpec",
           "model_config_taint_values", "ASSIGNED_ARCHS", "CORPUS_ARCHS",
           "get_config", "get_smoke_config", "all_configs"]

_MODULES = {
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "hymba-1.5b": "hymba_1_5b",
    "yi-9b": "yi_9b",
    "starcoder2-15b": "starcoder2_15b",
    "minicpm3-4b": "minicpm3_4b",
    "granite-20b": "granite_20b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "internvl2-26b": "internvl2_26b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "llama3-8b": "llama3_8b",
    "command-r7b": "command_r7b",
}

ASSIGNED_ARCHS = tuple(list(_MODULES)[:10])
CORPUS_ARCHS = tuple(_MODULES)          # 12-model corpus for §7.2


def _load(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _load(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _load(name).SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in _MODULES}
