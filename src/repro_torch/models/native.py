"""Fake-mode → native-mode parameter conversion (port of
``repro/models/native.py``, dense family).

Walks a parameter tree and replaces every quantizable linear's float master
``w`` with its integer carrier ``wq`` (:class:`~repro_torch.core.quantizers.
QTensor`: per-output-channel float scales, int8 or packed int4). Norms and
biases stay float. Layer-stacked ``[L, ...]`` leaves get per-layer scales
``[L, 1, N]``, as the reference's ``vmap(quantize_native)`` gives them.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.qtypes import QuantSpec
from repro_torch.core.quantizers import QTensor, quantize_native

__all__ = ["to_native", "NATIVE_SITES"]

# dict-valued linear sites of the dense family (each holds {"w": ..})
_LINEAR_KEYS = {"qkv", "attn_out", "w_in", "w_out", "lm_head", "embed"}
NATIVE_SITES = tuple(sorted(_LINEAR_KEYS))


def _quant(w: torch.Tensor, w_bits: int, stacked: bool) -> QTensor:
    spec = QuantSpec(bits=w_bits, per_channel=True, channel_axis=-1,
                     po2_scale=False)
    if not stacked:
        return quantize_native(w, spec)
    first = quantize_native(w[0], spec)
    data = torch.empty((w.shape[0], *first.data.shape),
                       dtype=first.data.dtype, device=w.device)
    scale = torch.empty((w.shape[0], *first.scale.shape),
                        dtype=first.scale.dtype, device=w.device)
    data[0], scale[0] = first.data, first.scale
    for l in range(1, w.shape[0]):          # one layer's f32 temporaries
        q = quantize_native(w[l], spec)
        data[l], scale[l] = q.data, q.scale
    return QTensor(data, scale, w_bits, w.shape[-1])


def to_native(params: Any, w_bits: int = 8) -> Any:
    """Convert recursively; the returned tree shares every leaf it does not
    quantize with ``params``."""

    def walk(node, name: str, stacked: bool):
        if not isinstance(node, dict):
            return node
        if "w" in node and name in _LINEAR_KEYS:
            out = {k: v for k, v in node.items() if k != "w"}
            out["wq"] = _quant(node["w"], w_bits, stacked)
            return out
        return {k: walk(v, k, stacked or k == "layers")
                for k, v in node.items()}

    return walk(params, "", False)
