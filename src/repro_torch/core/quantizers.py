"""Quantizers (port of ``repro/core/quantizers.py``): fake-quant forward
passes and native integer quantization.

Rounding is half away from zero (``sign·floor(|x|+0.5)``, HLS ``AP_RND``),
and every dynamic scale is an exact power of two (:func:`~repro_torch.core.
qtypes.exp2_int`). Bit-widths are host integers: the port keeps the bits
table on the host and passes each layer's entry as a Python int, so a
``bits >= 17`` row is a plain passthrough. The straight-through gradients
wait for the training slice.

``quantize_native`` / ``dequantize`` produce and consume the integer
carriers (:class:`QTensor`: int8, or int4 packed two per byte) of the
native serving path.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.aquant import aquant

from .qtypes import (QuantSpec, carrier_dtype, compute_scale, exp2_int,
                     pack_int4, qrange, qrange_dynamic, unpack_int4)

__all__ = ["fake_quant", "fake_quant_dynamic", "fake_quant_dynamic_token",
           "round_half_away", "QTensor", "quantize_native", "dequantize"]


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero (symmetric in sign, unlike ``torch.round``)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def fake_quant(x: torch.Tensor, spec: QuantSpec,
               scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize→dequantize ``x`` onto the grid of ``spec`` (float in/out);
    the scale is calibrated from ``max|x|`` unless given."""
    if spec.is_float:
        return x
    if spec.stochastic:
        raise NotImplementedError("stochastic rounding is not ported")
    xf = x.float()
    s = compute_scale(xf, spec) if scale is None else \
        torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    qmin, qmax = qrange(spec)
    q = torch.clamp(round_half_away(xf / s), qmin, qmax)
    return (q * s).to(x.dtype)


def fake_quant_dynamic(x: torch.Tensor, bits: int,
                       signed_sym=None) -> torch.Tensor:
    """Per-tensor dynamic fake-quant at ``bits`` (signed, non-symmetric
    grid; ``signed_sym`` is accepted for signature parity and ignored, as
    in the reference). ``bits >= 17`` is the identity. This is K5's
    function: CUDA tensors go through the kernel, CPU tensors through its
    plain version (:func:`repro_torch.kernels.aquant.aquant`)."""
    bits = int(bits)
    if bits >= 17:                       # float passthrough
        return x
    return aquant(x, bits, po2=True)


def fake_quant_dynamic_token(x: torch.Tensor, bits: int,
                             signed_sym=None) -> torch.Tensor:
    """Per-token variant: each trailing-axis row gets its own pow2 grid, so
    a token's values depend only on that token (plain torch, as the
    reference computes it in jnp)."""
    bits = int(bits)
    if bits >= 17:                       # float passthrough
        return x
    xf = x.float()
    qmin, qmax = qrange_dynamic(bits)
    amax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-9)
    scale = exp2_int(torch.ceil(torch.log2(amax / max(-qmin, qmax))))
    q = torch.clamp(round_half_away(xf / scale), qmin, qmax)
    return (q * scale).to(x.dtype)


class QTensor(NamedTuple):
    """A natively quantized tensor: integer carrier + scale + static info.

    ``data`` is int8 (int4 values packed two per byte when ``bits <= 4``);
    ``scale`` broadcasts against the *dequantized* shape. ``bits`` and the
    original trailing dim ``orig_last`` are host ints. A layer-stacked
    tensor carries ``[L, ...]`` data and scales; :meth:`layer` slices one.
    """

    data: torch.Tensor
    scale: torch.Tensor
    bits: int
    orig_last: int

    @property
    def shape(self):
        if self.bits <= 4:
            return (*self.data.shape[:-1], self.orig_last)
        return tuple(self.data.shape)

    def layer(self, l: int) -> "QTensor":
        """Layer ``l`` of a stacked tensor (views)."""
        return QTensor(self.data[l], self.scale[l], self.bits, self.orig_last)


def quantize_native(x: torch.Tensor, spec: QuantSpec,
                    scale: Optional[torch.Tensor] = None) -> QTensor:
    """Quantize to an integer carrier for storage and serving (no gradient
    path); the int grid matches the reference's bit for bit."""
    if spec.is_float:
        raise ValueError("a float spec has no integer carrier")
    xf = x.float()
    s = compute_scale(xf, spec) if scale is None else \
        torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    qmin, qmax = qrange(spec)
    q = torch.clamp(round_half_away(xf / s), qmin, qmax)
    if spec.bits <= 4:
        data = pack_int4(q.to(torch.int8))
    else:
        data = q.to(carrier_dtype(spec.bits))
    return QTensor(data=data, scale=s, bits=spec.bits, orig_last=x.shape[-1])


def dequantize(qt: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize a :class:`QTensor` back to floats: ``(q · scale)`` in f32,
    then ``dtype`` (the reference's plain path; K3 fuses this into the
    matmul)."""
    q = unpack_int4(qt.data) if qt.bits <= 4 else qt.data
    return (q.float() * qt.scale).to(dtype)
