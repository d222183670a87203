"""Quantization types (port of ``repro/core/qtypes.py``).

An arbitrary bit-width ``b`` is an integer grid of ``2**b`` levels held in
the narrowest carrier that fits (int8, or int4 packed two per byte), with a
power-of-two scale (the fixed-point faithful mode) or a float scale.

Power-of-two scales are built **exactly** here (:func:`exp2_int`): the
reference's ``jnp.exp2`` is inexact on the CPU
for integer exponents with ``|k| >= 13`` (up to 1e-6 relative), so at A16
its "power-of-two" activation grid is sometimes not one. The port's grid is.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = [
    "QuantSpec",
    "qrange",
    "qrange_dynamic",
    "compute_scale",
    "exp2_int",
    "pack_int4",
    "unpack_int4",
    "carrier_dtype",
    "nbytes_of",
    "FLOAT_SPEC",
]


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of one quantized datatype (the ``Ax``/``Wy`` of
    the paper). ``bits >= 17`` (or ``None``) means float passthrough; see
    the reference for the meaning of each field."""

    bits: Optional[int] = 8
    signed: bool = True
    symmetric: bool = False
    po2_scale: bool = True
    per_channel: bool = False
    channel_axis: int = -1
    stochastic: bool = False

    @property
    def is_float(self) -> bool:
        return self.bits is None or self.bits >= 17

    def __str__(self) -> str:  # e.g. "i8(po2)" / "i4/ch" / "f"
        if self.is_float:
            return "f"
        tags = []
        if self.po2_scale:
            tags.append("po2")
        if self.per_channel:
            tags.append("ch")
        if self.symmetric:
            tags.append("sym")
        t = ",".join(tags)
        return f"{'i' if self.signed else 'u'}{self.bits}" + (f"({t})" if t else "")

    def with_(self, **kw) -> "QuantSpec":
        return dataclasses.replace(self, **kw)


FLOAT_SPEC = QuantSpec(bits=None)


def qrange(spec: QuantSpec) -> tuple[int, int]:
    """(qmin, qmax) integer grid bounds for a spec."""
    if spec.is_float:
        raise ValueError("float spec has no integer grid")
    b = spec.bits
    if spec.signed:
        if spec.symmetric:
            return -(2 ** (b - 1) - 1), 2 ** (b - 1) - 1
        return -(2 ** (b - 1)), 2 ** (b - 1) - 1
    return 0, 2**b - 1


def qrange_dynamic(bits: int, signed: bool = True,
                   symmetric: bool = False) -> tuple[float, float]:
    """qmin/qmax for a per-layer bit-width. In the port the bits table is
    host data, so ``bits`` is a Python int and the bounds are exact."""
    bits = int(bits)
    if signed:
        qmax = float(2 ** (bits - 1) - 1)
        qmin = -(qmax + (0.0 if symmetric else 1.0))
    else:
        qmax = float(2 ** bits - 1)
        qmin = 0.0
    return qmin, qmax


def exp2_int(e: torch.Tensor) -> torch.Tensor:
    """``2**e`` for float tensors holding integers, exact: ``exp2`` in
    float64 is within one double ulp of ``2**e`` (CPU and CUDA libraries
    alike), and rounding that to float32 lands on ``2**e`` exactly — the
    float32 neighbours of a power of two are 2^-24 away. ``inf``/``nan``
    exponents propagate as in the reference."""
    return torch.exp2(e.double()).float()


def _reduce_dims(x: torch.Tensor, spec: QuantSpec) -> tuple[int, ...]:
    if not spec.per_channel:
        return tuple(range(x.ndim))
    ax = spec.channel_axis % x.ndim
    return tuple(a for a in range(x.ndim) if a != ax)


def compute_scale(x: torch.Tensor, spec: QuantSpec,
                  eps: float = 1e-9) -> torch.Tensor:
    """Scale from the max-abs of ``x`` (per tensor or per channel); po2 mode
    rounds the scale *up* to the next power of two."""
    qmin, qmax = qrange(spec)
    amax = x.float().abs().amax(dim=_reduce_dims(x, spec),
                                keepdim=spec.per_channel)
    amax = amax.clamp_min(eps)
    scale = amax / float(max(qmax, -qmin))
    if spec.po2_scale:
        scale = exp2_int(torch.ceil(torch.log2(scale)))
    return scale


def carrier_dtype(bits: int) -> torch.dtype:
    """Narrowest storage dtype for a native-quantized tensor of width ``bits``."""
    return torch.int8 if bits <= 8 else torch.int16


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack signed int4 values (int8-carried, in [-8, 7]) two per byte.
    Low nibble = even index, high nibble = odd index."""
    if q.shape[-1] % 2:
        raise ValueError("pack_int4 needs an even trailing axis")
    u = q.to(torch.int8).view(torch.uint8)
    lo = u[..., 0::2] & 0x0F
    hi = (u[..., 1::2] & 0x0F) << 4
    return (lo | hi).view(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4` — int8-carried int4 values, each nibble
    sign-extended (the arithmetic shift of the reference)."""
    w = p.to(torch.int16)
    lo = ((w & 0x0F) ^ 8) - 8
    hi = w >> 4
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*p.shape[:-1], p.shape[-1] * 2).to(torch.int8)


def nbytes_of(shape: tuple[int, ...], spec: QuantSpec) -> int:
    """Storage bytes for a native-quantized tensor (int4 counts 0.5 B/elt)."""
    n = int(np.prod(shape))
    if spec.is_float:
        return n * 2  # bf16 reference storage
    if spec.bits <= 4:
        return (n + 1) // 2
    if spec.bits <= 8:
        return n
    return n * 2
