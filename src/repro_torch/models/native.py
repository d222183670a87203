"""Fake-mode → native-mode parameter conversion (port of
``repro/models/native.py``, every family).

Walks a parameter tree and replaces every quantizable linear's float master
``w`` with its integer carrier ``wq`` (:class:`~repro_torch.core.quantizers.
QTensor`: per-output-channel float scales, int8 or packed int4). The MoE
block's raw routed-expert stacks (``moe.w_in`` ``[L, E, d, 2f]``,
``moe.w_out`` ``[L, E, f, d]``) become ``QTensor`` leaves themselves, with
per-output-channel scales reduced over the expert and input axes. The
audio stack's ``embed`` is a linear over frame features and converts as
one (``[feature_dim, d_model]``). Norms (a layer norm's shift too),
biases (qwen2-vl's on ``qkv``), the SSD block's conv weights and its
per-head scalars stay float.
Layer-stacked ``[L, ...]`` leaves get per-layer scales (``[L, 1, N]``,
``[L, 1, 1, N]`` on a routed stack), as the reference's
``vmap(quantize_native)`` gives them.
Packed int4 needs an even output width ``N``: a leaf with an odd one (the
untied ``lm_head`` of hymba-1.5b, vocab 32001) is refused by name, as the
reference's ``pack_int4`` refuses it.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.qtypes import QuantSpec
from repro_torch.core.quantizers import QTensor, quantize_native

__all__ = ["to_native", "NATIVE_SITES"]

# dict-valued linear sites ({"w": ..} each) and the raw MoE stacks
_LINEAR_KEYS = {"qkv", "attn_out", "w_in", "w_out", "shared_in",
                "shared_out", "router", "in_proj", "out_proj", "lm_head",
                "embed"}
_RAW_KEYS = {"w_in", "w_out"}   # inside "moe": stacked [L, E, ...] tensors
NATIVE_SITES = tuple(sorted(_LINEAR_KEYS))


def _quant(w: torch.Tensor, w_bits: int, stacked: bool,
           path: str) -> QTensor:
    if w_bits == 4 and w.shape[-1] % 2:
        raise ValueError(f"{path}: packed int4 stores two output channels "
                         f"per byte; its N {w.shape[-1]} is odd")
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

    def walk(node, path: str, name: str, stacked: bool):
        if not isinstance(node, dict):
            return node
        if "w" in node and name in _LINEAR_KEYS:
            out = {k: v for k, v in node.items() if k != "w"}
            out["wq"] = _quant(node["w"], w_bits, stacked, path)
            return out
        out = {}
        for k, v in node.items():
            sub = f"{path}.{k}" if path else k
            if (name == "moe" and k in _RAW_KEYS
                    and isinstance(v, torch.Tensor)):
                out[k] = _quant(v, w_bits, stacked, sub)
            else:
                out[k] = walk(v, sub, k, stacked or k == "layers")
        return out

    return walk(params, "", "", False)
