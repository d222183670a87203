"""Quantizers (port of ``repro/core/quantizers.py``): fake-quant forward
passes and native integer quantization.

Rounding is half away from zero (``sign·floor(|x|+0.5)``, HLS ``AP_RND``),
and every dynamic scale is an exact power of two (:func:`~repro_torch.core.
qtypes.exp2_int`). Bit-widths are host integers: the port keeps the bits
table on the host and passes each layer's entry as a Python int, so a
``bits >= 17`` row is a plain passthrough.

The three fake-quants carry the reference's straight-through gradient (its
``custom_vjp``s): ``dL/dx = g`` where ``qmin·s <= x <= qmax·s`` and 0
outside, compared in f32; ``bits`` gets none. Only a call that records a
graph (grad mode on, ``x.requires_grad``) goes through the
``autograd.Function``, which saves ``x`` and the scale and builds the mask
in ``backward``; inference calls run the forward alone, as before.

Stochastic rounding (``QuantSpec(stochastic=True)``) is ``floor(x + U)``
with ``U ~ uniform[0, 1)``, as the reference's ``_round``. The draw is
kept apart from the arithmetic: :func:`round_stochastic` takes the
uniforms, and :func:`fake_quant` draws them from a ``torch.Generator``
where the reference takes a PRNG key (or takes them as given).

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
           "round_half_away", "round_stochastic", "QTensor", "quantize_native", "dequantize"]


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero (symmetric in sign, unlike ``torch.round``)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def round_stochastic(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``floor(x + u)``: stochastic rounding given the uniforms ``u`` (one
    per element of ``x``, in ``[0, 1)``), unbiased over ``u``."""
    return torch.floor(x + u)


class _StraightThrough(torch.autograd.Function):
    """``y = quantize(x)[0]`` forward; ``g · [qmin·s <= x <= qmax·s]``
    backward (in ``x``'s type), with ``s = quantize(x)[1]`` saved beside
    ``x``."""

    @staticmethod
    def forward(ctx, x, quantize, qmin, qmax):
        y, scale = quantize(x)
        ctx.save_for_backward(x, scale)
        ctx.qrange = (qmin, qmax)
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        qmin, qmax = ctx.qrange
        xf = x.float()
        mask = (xf >= qmin * scale) & (xf <= qmax * scale)
        # a quantize that stored another type than x's hands the gradient
        # back in x's, as the cast after an unfused call would
        g = g.to(x.dtype)
        return g * mask.to(g.dtype), None, None, None


def _quantize(x: torch.Tensor, quantize, qmin, qmax) -> torch.Tensor:
    """``quantize(x)[0]``, through the straight-through ``Function`` only
    when autograd records this call."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _StraightThrough.apply(x, quantize, qmin, qmax)
    return quantize(x)[0]


def fake_quant(x: torch.Tensor, spec: QuantSpec,
               scale: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize→dequantize ``x`` onto the grid of ``spec`` (float in/out);
    the scale is calibrated from ``max|x|`` unless given. Gradient:
    straight through inside the clip range, zero outside.

    With ``spec.stochastic`` the rounding is :func:`round_stochastic` on
    ``uniforms`` (f32, ``x``'s shape), drawn from ``generator`` (on
    ``x``'s device) when not given; one of the two is required, as the
    reference requires a key."""
    if spec.is_float:
        return x
    if spec.stochastic and uniforms is None:
        if generator is None:
            raise ValueError("stochastic rounding needs a generator or "
                             "uniforms")
        uniforms = torch.rand(x.shape, generator=generator,
                              dtype=torch.float32, device=x.device)
    qmin, qmax = qrange(spec)

    def quantize(x):
        xf = x.float()
        s = compute_scale(xf, spec) if scale is None else \
            torch.as_tensor(scale, dtype=torch.float32, device=x.device)
        r = xf / s
        r = (round_stochastic(r, uniforms) if spec.stochastic
             else round_half_away(r))
        q = torch.clamp(r, qmin, qmax)
        return (q * s).to(x.dtype), s

    return _quantize(x, quantize, qmin, qmax)


def fake_quant_dynamic(x: torch.Tensor, bits: int, signed_sym=None,
                       out_dtype=None) -> torch.Tensor:
    """Per-tensor dynamic fake-quant at ``bits`` (signed, non-symmetric
    grid; ``signed_sym`` is accepted for signature parity and ignored, as
    in the reference). ``bits >= 17`` is the identity. This is K5's
    function: CUDA tensors go through the kernel, CPU tensors through its
    plain version (:func:`repro_torch.kernels.aquant.aquant`); under
    autograd the kernel also hands back the scale for the gradient's clip
    band.

    ``out_dtype`` (``x``'s own, or bf16 from f32) is the type the caller
    computes in: the kernel stores in it, and the result, and under
    autograd its gradient (in ``x``'s type), are those of
    ``fake_quant_dynamic(x, bits).to(out_dtype)``."""
    bits = int(bits)
    if bits >= 17:                       # float passthrough
        return x if out_dtype is None else x.to(out_dtype)
    if torch.is_grad_enabled() and x.requires_grad:
        qmin, qmax = qrange_dynamic(bits)
        return _StraightThrough.apply(
            x, lambda t: aquant(t, bits, po2=True, return_scale=True,
                                out_dtype=out_dtype), qmin, qmax)
    return aquant(x, bits, po2=True, out_dtype=out_dtype)


def fake_quant_dynamic_token(x: torch.Tensor, bits: int,
                             signed_sym=None) -> torch.Tensor:
    """Per-token variant: each trailing-axis row gets its own pow2 grid, so
    a token's values depend only on that token (plain torch, as the
    reference computes it in jnp)."""
    bits = int(bits)
    if bits >= 17:                       # float passthrough
        return x
    qmin, qmax = qrange_dynamic(bits)

    def quantize(x):
        xf = x.float()
        amax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-9)
        scale = exp2_int(torch.ceil(torch.log2(amax / max(-qmin, qmax))))
        q = torch.clamp(round_half_away(xf / scale), qmin, qmax)
        return (q * scale).to(x.dtype), scale

    return _quantize(x, quantize, qmin, qmax)


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
