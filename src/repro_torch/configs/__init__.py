"""Config registry of the ported architectures: ``get_config(name)`` /
``get_smoke_config(name)``.

Only architectures whose whole path the port runs are registered; the JAX
package's registry (``repro.configs``) lists the full corpus.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    SHAPES, MLAConfig, ModelConfig, ShapeSpec, model_config_taint_values)

__all__ = ["SHAPES", "MLAConfig", "ModelConfig", "ShapeSpec",
           "model_config_taint_values", "get_config", "get_smoke_config"]

_MODULES = {
    "llama3-8b": "llama3_8b",
    "command-r7b": "command_r7b",
    "yi-9b": "yi_9b",
    "starcoder2-15b": "starcoder2_15b",
    "granite-20b": "granite_20b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "minicpm3-4b": "minicpm3_4b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "hymba-1.5b": "hymba_1_5b",
}


def _load(name: str):
    if name not in _MODULES:
        raise KeyError(f"architecture {name!r} is not ported; "
                       f"ported: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _load(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _load(name).SMOKE

