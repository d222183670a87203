"""Architecture registry of the port. The dense granite-3-2b is the first
slice; the other families of ``repro.configs`` follow with their models."""
from __future__ import annotations

import importlib

from .common import ModelConfig, smoke_of

_MODULES = {
    "granite-3-2b": "granite_3_2b",
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


__all__ = ["ARCHS", "ModelConfig", "get_config", "get_smoke", "smoke_of"]
