"""Per-tensor dynamic fake-quant: the Hopper kernel's wrapper (K5) and its
plain version.

:func:`aquant` replaces the Pallas TPU kernel ``aquant_pallas`` of
``repro/kernels/aquant.py``; source ``csrc/aquant.cu``, built and bound by
:mod:`repro_torch.kernels.build`. Over the whole tensor: ``amax`` floored at
1e-9, ``scale = amax / 2^(b−1)`` (with ``po2``: ``2^ceil(log2 scale)``),
round half away from zero, clip to the signed ``bits`` grid, in ``x``'s type
(f32 or bf16). It is the per-tensor case of
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


def aquant_ref(x: torch.Tensor, bits: int = 8, po2: bool = True
               ) -> torch.Tensor:
    """Plain version (port of ``repro/kernels/ref.py::aquant_ref``): the
    reference's ``fake_quant`` numerics with an exact power-of-two scale."""
    xf = x.float()
    half = 2.0 ** (bits - 1)
    amax = xf.abs().amax().clamp_min(1e-9)
    scale = amax / half
    if po2:
        scale = exp2_int(torch.ceil(torch.log2(scale)))
    r = xf / scale
    q = torch.clamp(torch.sign(r) * torch.floor(torch.abs(r) + 0.5),
                    -half, half - 1.0)
    return (q * scale).to(x.dtype)


def aquant(x: torch.Tensor, bits: int = 8, po2: bool = True) -> torch.Tensor:
    """Fake-quantize ``x`` onto its dynamic per-tensor ``bits`` grid (same
    shape and type). CPU tensors take the plain version; CUDA tensors launch
    the kernel (two launches, counted once in ``aquant.launches``) or
    raise."""
    if x.device.type == "cpu":
        return aquant_ref(x, bits, po2)
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
        return out
    n_partial = max(1, min(_MAX_PARTIALS, -(-n // 4096)))
    partial = torch.empty((n_partial,), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib("aquant").repro_aquant(
        xc.data_ptr(), out.data_ptr(), partial.data_ptr(), n,
        int(x.dtype == torch.bfloat16), int(bits), int(bool(po2)), n_partial,
        stream)
    if err != 0:
        raise RuntimeError(f"aquant kernel launch failed: CUDA error {err}")
    aquant.launches += 1
    return out


aquant.launches = 0
