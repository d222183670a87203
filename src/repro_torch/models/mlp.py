"""Gated (SwiGLU) feed-forward block (port of ``repro/models/mlp.py``)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .layers import init_linear, qlinear
from .pshard import constrain

__all__ = ["init_mlp", "mlp"]


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, *,
             gated: bool = True, layers: Optional[int] = None,
             device=None) -> dict:
    return {
        "w_in": init_linear(gen, d_model, d_ff * (2 if gated else 1),
                            layers=layers, device=device),
        "w_out": init_linear(gen, d_ff, d_model, layers=layers,
                             device=device),
    }


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu default
    raise ValueError(name)


def mlp(params: dict, x: torch.Tensor, bits_in, bits_out, *,
        gated: bool = True, act: str = "silu") -> torch.Tensor:
    """``bits_in``/``bits_out``: the (a, w) pairs of the ``mlp_in`` and
    ``mlp_out`` quant sites (gate and up share one site)."""
    h = qlinear(params["w_in"], x, bits_in)
    if gated:
        g, u = torch.chunk(h, 2, dim=-1)
        h = _act(act, g) * u
    else:
        h = _act(act, h)
    if h.ndim == 3:  # keep d_ff on the TP axis (Megatron col→row)
        h = constrain(h, "dp", None, "tp")
    return qlinear(params["w_out"], h, bits_out)
