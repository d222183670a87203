"""Public wrappers around the dequant-matmul (port of ``repro/kernels/ops.py``).

``qmatmul`` is the entry point of the native integer-weight path
(``models.layers.qlinear`` at bf16 compute): it flattens the leading dims of
``x`` to M, broadcasts a scalar scale to ``[N]``, and carries a gradient to
the activations only — the integer carriers and their calibrated scales are
frozen, as in the reference's ``custom_vjp``. The forward is K3 on CUDA
tensors and its plain version on CPU tensors
(:func:`repro_torch.kernels.qmatmul.qmatmul`); the kernel masks ragged edges
itself, so no padding copies are made. The backward is plain torch, as the
reference's is jnp.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.quantizers import QTensor
from repro_torch.kernels import qmatmul as K

__all__ = ["qmatmul", "qmatmul_qt"]


class _QMatmul(torch.autograd.Function):
    """``x2 [M, K] @ dequant(w_q)``; dx = ``g.f32 @ dequant(w).T`` in x's
    dtype, no gradient for ``w_q`` or ``scale``."""

    @staticmethod
    def forward(ctx, x2, w_q, scale_v, bits, out_bits, out_scale):
        ctx.save_for_backward(w_q, scale_v)
        ctx.bits = bits
        ctx.x_dtype = x2.dtype
        return K.qmatmul(x2, w_q, scale_v, bits=bits, out_bits=out_bits,
                         out_scale=out_scale)

    @staticmethod
    def backward(ctx, g):
        w_q, scale_v = ctx.saved_tensors
        w = K.dequant_ref(w_q, scale_v, ctx.bits)
        dx = (g.float() @ w.t()).to(ctx.x_dtype)
        return dx, None, None, None, None, None


def qmatmul(x: torch.Tensor, w_q: torch.Tensor, scale, bits: int = 8,
            out_bits: Optional[int] = None,
            out_scale: Optional[float] = None) -> torch.Tensor:
    """``x[..., K] @ dequant(w_q)[K, N]`` → ``[..., N]`` f32. ``w_q`` int8
    ``[K, N]`` (bits 5–8) or packed int4 ``[K, N/2]`` (bits ≤ 4); ``scale``
    scalar or ``[N]`` (any shape holding N values, e.g. a QTensor's
    ``[1, N]``)."""
    *lead, k = x.shape
    m = int(np.prod(lead)) if lead else 1
    n = w_q.shape[-1] * (2 if bits <= 4 else 1)
    x2 = x.reshape(m, k).contiguous()
    scale_v = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    scale_v = scale_v.reshape(-1).expand(n).contiguous()
    y = _QMatmul.apply(x2, w_q.contiguous(), scale_v, int(bits), out_bits,
                       out_scale)
    return y.reshape(*lead, n)


def qmatmul_qt(x: torch.Tensor, qt: QTensor, *,
               out_bits: Optional[int] = None,
               out_scale: Optional[float] = None) -> torch.Tensor:
    """:func:`qmatmul` on the :class:`QTensor` from ``quantize_native``."""
    return qmatmul(x, qt.data, qt.scale, qt.bits, out_bits, out_scale)
