"""Per-tensor dynamic fake-quant: the Hopper kernel's wrapper (K5) and its
plain version.

:func:`aquant` replaces the Pallas TPU kernel ``aquant_pallas`` of
``repro/kernels/aquant.py``; source ``csrc/aquant.cu``, built and bound by
:mod:`repro_torch.kernels.build`. Over the whole tensor: ``amax`` floored at
1e-9, ``scale = amax / 2^(b−1)`` (with ``po2``: ``2^ceil(log2 scale)``),
round half away from zero, clip to the signed ``bits`` grid, in ``x``'s type
(f32 or bf16). With ``return_scale`` the kernel also writes the scale it
derived, which the straight-through gradient's clip band needs. It is the
per-tensor case of
:func:`repro_torch.core.quantizers.fake_quant_dynamic`, which calls it.

The amax is shape-agnostic, so any contiguous shape goes through as a flat
array. The wrapper runs the plain version for CPU tensors and the kernel
for CUDA tensors — it never falls back from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.core.qtypes import exp2_int
from repro_torch.kernels.build import lib

__all__ = ["aquant", "aquant_ref"]

_MAX_PARTIALS = 1024          # first-pass blocks (one partial max each)


def _scale(amax: torch.Tensor, bits: int, po2: bool) -> torch.Tensor:
    """The grid's f32 scale from a tensor's ``max|x|``."""
    scale = amax.clamp_min(1e-9) / 2.0 ** (bits - 1)
    return exp2_int(torch.ceil(torch.log2(scale))) if po2 else scale


def aquant_ref(x: torch.Tensor, bits: int = 8, po2: bool = True,
               return_scale: bool = False):
    """Plain version (port of ``repro/kernels/ref.py::aquant_ref``): the
    reference's ``fake_quant`` numerics with an exact power-of-two scale.
    With ``return_scale``, also the 0-d f32 scale of the grid."""
    xf = x.float()
    half = 2.0 ** (bits - 1)
    scale = _scale(xf.abs().amax(), bits, po2)
    r = xf / scale
    q = torch.clamp(torch.sign(r) * torch.floor(torch.abs(r) + 0.5),
                    -half, half - 1.0)
    out = (q * scale).to(x.dtype)
    return (out, scale) if return_scale else out


def aquant(x: torch.Tensor, bits: int = 8, po2: bool = True,
           return_scale: bool = False):
    """Fake-quantize ``x`` onto its dynamic per-tensor ``bits`` grid (same
    shape and type); with ``return_scale``, also the grid's 0-d f32 scale,
    which the kernel writes beside its output (no second pass, no host
    sync). CPU tensors take the plain version; CUDA tensors launch the
    kernel (two launches, counted once in ``aquant.launches``) or raise."""
    if x.device.type == "cpu":
        return aquant_ref(x, bits, po2, return_scale)
    if not 2 <= bits <= 16:
        raise ValueError(f"aquant supports bits 2..16, got {bits}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be f32 or bf16, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    xc = x.contiguous()
    out = torch.empty_like(xc)
    n = xc.numel()
    if n == 0:
        if return_scale:
            return out, _scale(torch.zeros((), device=x.device), bits, po2)
        return out
    n_partial = max(1, min(_MAX_PARTIALS, -(-n // 4096)))
    partial = torch.empty((n_partial + return_scale,), dtype=torch.float32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib("aquant").repro_aquant(
        xc.data_ptr(), out.data_ptr(), partial.data_ptr(),
        partial[n_partial:].data_ptr() if return_scale else None, n,
        int(x.dtype == torch.bfloat16), int(bits), int(bool(po2)), n_partial,
        stream)
    if err != 0:
        raise RuntimeError(f"aquant kernel launch failed: CUDA error {err}")
    aquant.launches += 1
    return (out, partial[n_partial].view(())) if return_scale else out


aquant.launches = 0
