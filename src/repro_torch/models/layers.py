"""Quantization-aware building blocks (port of ``repro/models/layers.py``).

Every matmul runs through :func:`qlinear`, so the paper's per-layer
``Ax-Wy`` profiles apply uniformly. Three branches, switched on the
parameter layout: ``w`` (float master weights, weights and activations
fake-quantized per call), ``wfq`` (a weight image fake-quantized once per
profile ahead of the decode loop — :func:`repro_torch.models.transformer.
prequant_decode_weights`) and ``wq`` (native mode: an integer carrier,
:class:`~repro_torch.core.quantizers.QTensor`, from
:func:`repro_torch.models.native.to_native`). ``bits_aw`` is an ``(a_bits,
w_bits)`` pair of host ints; bits ≥ 17 is float passthrough.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.qtypes import QuantSpec, unpack_int4
from repro_torch.core.quantizers import (QTensor, dequantize,
                                         fake_quant_dynamic,
                                         fake_quant_dynamic_token,
                                         quantize_native)
from repro_torch.kernels import ops
from repro_torch.runtime import compute_dtype as _default_compute_dtype

__all__ = ["qlinear", "init_linear", "quantize_linear_native",
           "dequant_matmul", "rms_norm", "init_norm", "embed_lookup",
           "init_embed", "SIGNED_SYM"]

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


def dequant_matmul(xq: torch.Tensor, qt: QTensor,
                   compute_dtype: torch.dtype) -> torch.Tensor:
    """The reference's native product outside any kernel: dequantize the
    carrier to the compute dtype, then a plain matmul. Counted in
    ``dequant_matmul.calls``."""
    dequant_matmul.calls += 1
    return torch.matmul(xq.to(compute_dtype), dequantize(qt, compute_dtype))


dequant_matmul.calls = 0


def qlinear(params: dict, x: torch.Tensor, bits_aw) -> torch.Tensor:
    """Quantization-aware linear. Activations quantize **per token**; the
    weight image (``wfq``) or master (``w``, quantized here per tensor)
    meets them in the compute dtype with f32 accumulation.

    Native (``wq``): at bf16 compute the product is
    :func:`repro_torch.kernels.ops.qmatmul` — K3 on the card, the same
    function as the reference's ``dot(xq.bf16, dequant(wq).bf16)`` with
    f32 accumulation. At f32 compute K3 would round the operands to bf16
    where the reference does not, so the reference's own code runs:
    :func:`dequant_matmul`. That is a rule on the compute dtype, not a
    fallback: a failure of K3 raises."""
    compute_dtype = _default_compute_dtype(x.device)
    a_bits = int(bits_aw[0])
    xq = fake_quant_dynamic_token(x, a_bits, SIGNED_SYM)
    if "wq" in params:
        qt = params["wq"]
        if compute_dtype == torch.bfloat16:
            y = ops.qmatmul(xq, qt.data, qt.scale, qt.bits)
        else:
            y = dequant_matmul(xq, qt, compute_dtype)
    else:
        if "wfq" in params:
            w = params["wfq"]
        else:
            w = fake_quant_dynamic(params["w"], int(bits_aw[1]), SIGNED_SYM)
        y = torch.matmul(xq.to(compute_dtype), w.to(compute_dtype))
    if "b" in params:
        y = y.float() + params["b"].float()
    return y.to(compute_dtype)


def quantize_linear_native(params: dict, w_bits: int = 8) -> dict:
    """Convert a fake-mode linear to native integer storage (deployment):
    per-output-channel float scales."""
    spec = QuantSpec(bits=w_bits, per_channel=True, channel_axis=-1,
                     po2_scale=False)
    out = {"wq": quantize_native(params["w"], spec)}
    if "b" in params:
        out["b"] = params["b"]
    return out


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
    """Embedding gather with weight-only quantization (the table's grid).
    Native: gather the int rows, unpack int4, dequantize after the gather."""
    compute_dtype = _default_compute_dtype(ids.device)
    if "wq" in params:
        qt = params["wq"]
        rows = qt.data[ids]
        if qt.bits <= 4:
            rows = unpack_int4(rows)
        return (rows.float() * qt.scale).to(compute_dtype)
    if "wfq" in params:
        return params["wfq"][ids].to(compute_dtype)
    w = fake_quant_dynamic(params["w"], int(bits_aw[1]), SIGNED_SYM)
    return w.to(compute_dtype)[ids]
