"""Fake-quant forward passes (port of ``repro/core/quantizers.py``).

Rounding is half away from zero (``sign·floor(|x|+0.5)``, HLS ``AP_RND``),
and every dynamic scale is an exact power of two (:func:`~repro_torch.core.
qtypes.exp2_int`). Bit-widths are host integers: the port keeps the bits
table on the host and passes each layer's entry as a Python int, so a
``bits >= 17`` row is a plain passthrough. The straight-through gradients
wait for the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from .qtypes import QuantSpec, compute_scale, exp2_int, qrange, qrange_dynamic

__all__ = ["fake_quant", "fake_quant_dynamic", "fake_quant_dynamic_token",
           "round_half_away"]


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


def _fqd(x: torch.Tensor, bits: int, dim: Optional[int]) -> torch.Tensor:
    bits = int(bits)
    if bits >= 17:                       # float passthrough
        return x
    xf = x.float()
    qmin, qmax = qrange_dynamic(bits)
    if dim is None:
        amax = xf.abs().amax().clamp_min(1e-9)
    else:
        amax = xf.abs().amax(dim=dim, keepdim=True).clamp_min(1e-9)
    scale = exp2_int(torch.ceil(torch.log2(amax / max(-qmin, qmax))))
    q = torch.clamp(round_half_away(xf / scale), qmin, qmax)
    return (q * scale).to(x.dtype)


def fake_quant_dynamic(x: torch.Tensor, bits: int,
                       signed_sym=None) -> torch.Tensor:
    """Per-tensor dynamic fake-quant at ``bits`` (signed, non-symmetric
    grid; ``signed_sym`` is accepted for signature parity and ignored, as
    in the reference). ``bits >= 17`` is the identity."""
    return _fqd(x, bits, None)


def fake_quant_dynamic_token(x: torch.Tensor, bits: int,
                             signed_sym=None) -> torch.Tensor:
    """Per-token variant: each trailing-axis row gets its own pow2 grid, so
    a token's values depend only on that token."""
    return _fqd(x, bits, -1)
