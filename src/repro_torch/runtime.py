"""Device choice and compute dtype (port of ``repro/runtime.py``).

Entry points run on the GPU unless the caller asks for the CPU: with no
CUDA device and no explicit ``device="cpu"``, :func:`resolve_device`
raises — nothing falls back to the CPU silently.

``compute_dtype`` mirrors the reference's switch: bf16 on the accelerator
(CUDA here, the TPU there), f32 on the CPU, with the same process-wide
override (:func:`set_compute_dtype` / :func:`use_compute_dtype`).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

__all__ = ["resolve_device", "compute_dtype", "set_compute_dtype",
           "use_compute_dtype"]

_OVERRIDE: Optional[torch.dtype] = None


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for something else. Raises when CUDA is requested (explicitly or by
    default) but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless the caller "
            "passes device='cpu'")
    return dev


def compute_dtype(device: Union[str, torch.device, None] = None
                  ) -> torch.dtype:
    """bf16 on CUDA, f32 elsewhere — unless overridden."""
    if _OVERRIDE is not None:
        return _OVERRIDE
    if device is not None and torch.device(device).type == "cuda":
        return torch.bfloat16
    return torch.float32


def set_compute_dtype(dt: Optional[torch.dtype]) -> None:
    global _OVERRIDE
    _OVERRIDE = dt


@contextlib.contextmanager
def use_compute_dtype(dt: Optional[torch.dtype]):
    global _OVERRIDE
    prev = _OVERRIDE
    _OVERRIDE = dt
    try:
        yield
    finally:
        _OVERRIDE = prev
