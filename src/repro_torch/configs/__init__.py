"""Architecture registry of the port: the dense granite-3-2b, the MoE
qwen2-moe-a2.7b and deepseek-moe-16b, the SSM mamba2-130m and the hybrid
hymba-1.5b; the other families of ``repro.configs`` follow with their
models."""
from __future__ import annotations

import importlib

from .common import ModelConfig, MoEConfig, smoke_of

_MODULES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "granite-3-2b": "granite_3_2b",
    "mamba2-130m": "mamba2_130m",
    "hymba-1.5b": "hymba_1_5b",
}

ARCHS = tuple(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: {ARCHS}")
    return importlib.import_module(f".{_MODULES[name]}", __package__)


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


__all__ = ["ARCHS", "ModelConfig", "MoEConfig", "get_config", "get_smoke",
           "smoke_of"]
