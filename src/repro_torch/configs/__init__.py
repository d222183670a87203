"""Architecture registry of the port: the reference's ten architectures
(``repro.configs.ARCHS``, in its order), each with its published
``CONFIG`` and reduced ``SMOKE``. ``get_config(name)`` /
``get_smoke(name)`` resolve by arch id (``--arch``); ``SHAPES`` /
``shape_applicable`` come from common."""
from __future__ import annotations

import importlib

from .common import (SHAPES, ModelConfig, MoEConfig, Shape, shape_applicable,
                     smoke_of)

_MODULES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen2-72b": "qwen2_72b",
    "glm4-9b": "glm4_9b",
    "granite-3-2b": "granite_3_2b",
    "qwen1.5-110b": "qwen1_5_110b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "mamba2-130m": "mamba2_130m",
    "hymba-1.5b": "hymba_1_5b",
    "hubert-xlarge": "hubert_xlarge",
}

ARCHS = tuple(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return importlib.import_module(f".{_MODULES[name]}", __package__)


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


__all__ = ["ARCHS", "ModelConfig", "MoEConfig", "get_config", "get_smoke",
           "SHAPES", "Shape", "shape_applicable", "smoke_of"]
