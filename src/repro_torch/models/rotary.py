"""Rotary position embeddings (port of ``repro/models/rotary.py``, RoPE)."""
from __future__ import annotations

import torch

__all__ = ["rope_freqs", "apply_rope"]


def rope_freqs(head_dim: int, theta: float = 1e4, device=None) -> torch.Tensor:
    """Inverse frequencies ``[head_dim/2]``."""
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """``x [B, S, H, D]``, ``positions [B, S]`` int → rotated x (half-split
    layout)."""
    inv = rope_freqs(x.shape[-1], theta, device=x.device)    # [D/2]
    ang = positions.float()[..., None] * inv                 # [B, S, D/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)
