"""Quantization-aware building blocks (port of ``repro/models/layers.py``).

Every matmul runs through :func:`qlinear`, so the paper's per-layer
``Ax-Wy`` profiles apply uniformly. Two branches share one layout: ``w``
(float master weights, weights and activations fake-quantized per call)
and ``wfq`` (a weight image fake-quantized once per profile ahead of the
decode loop — :func:`repro_torch.models.transformer.prequant_decode_weights`).
``bits_aw`` is an ``(a_bits, w_bits)`` pair of host ints; bits ≥ 17 is float
passthrough.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.quantizers import (fake_quant_dynamic,
                                         fake_quant_dynamic_token)
from repro_torch.runtime import compute_dtype as _default_compute_dtype

__all__ = ["qlinear", "init_linear", "rms_norm", "init_norm",
           "embed_lookup", "init_embed", "SIGNED_SYM"]

SIGNED_SYM = np.array([1, 0], np.int32)  # fixed (signed, non-symmetric) grid


def init_linear(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False, scale: float | None = None,
                layers: Optional[int] = None, device=None) -> dict:
    """``w ~ N(0, 1) · scale`` (default ``1/sqrt(d_in)``), the reference's
    distribution; ``layers`` stacks ``L`` independent draws on axis 0."""
    s = (1.0 / np.sqrt(d_in)) if scale is None else scale
    lead = () if layers is None else (layers,)
    w = torch.randn(*lead, d_in, d_out, generator=gen, device=device,
                    dtype=torch.float32) * s
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros(*lead, d_out, device=device)
    return p


def qlinear(params: dict, x: torch.Tensor, bits_aw) -> torch.Tensor:
    """Quantization-aware linear. Activations quantize **per token**; the
    weight image (``wfq``) or master (``w``, quantized here per tensor)
    meets them in the compute dtype with f32 accumulation."""
    compute_dtype = _default_compute_dtype(x.device)
    a_bits = int(bits_aw[0])
    xq = fake_quant_dynamic_token(x, a_bits, SIGNED_SYM)
    if "wfq" in params:
        w = params["wfq"]
    elif "w" in params:
        w = fake_quant_dynamic(params["w"], int(bits_aw[1]), SIGNED_SYM)
    else:
        raise NotImplementedError("native integer linears are not ported")
    y = torch.matmul(xq.to(compute_dtype), w.to(compute_dtype))
    if "b" in params:
        y = y.float() + params["b"].float()
    return y.to(compute_dtype)


def init_norm(d: int, *, layers: Optional[int] = None, device=None) -> dict:
    lead = () if layers is None else (layers,)
    return {"g": torch.ones(*lead, d, device=device)}


def rms_norm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["g"]
    return y.to(x.dtype)


def init_embed(gen: torch.Generator, vocab: int, d: int, device=None) -> dict:
    return {"w": torch.randn(vocab, d, generator=gen, device=device,
                             dtype=torch.float32) * 0.02}


def embed_lookup(params: dict, ids: torch.Tensor, bits_aw) -> torch.Tensor:
    """Embedding gather with weight-only quantization (the table's grid)."""
    compute_dtype = _default_compute_dtype(ids.device)
    if "wfq" in params:
        return params["wfq"][ids].to(compute_dtype)
    w = fake_quant_dynamic(params["w"], int(bits_aw[1]), SIGNED_SYM)
    return w.to(compute_dtype)[ids]
