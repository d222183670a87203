"""Rotary position embeddings (port of ``repro/models/rotary.py``): RoPE
and the multimodal M-RoPE of Qwen2-VL.

M-RoPE splits the head dimension's frequency pairs into (temporal, height,
width) sections, each rotated by its own position stream; with text
positions (all three streams equal) it is RoPE, bit for bit — the same
f32 angles, ``cos``/``sin`` and half-split rotation.
"""
from __future__ import annotations

import torch

__all__ = ["rope_freqs", "apply_rope", "apply_mrope", "text_mrope_positions"]


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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: tuple[int, ...], theta: float = 1e4) -> torch.Tensor:
    """M-RoPE. ``x [B, S, H, D]``, ``positions [B, 3, S]`` (t/h/w streams);
    ``sections`` gives the number of frequency pairs each stream drives, in
    order, summing to ``D/2``."""
    b, s, _, d = x.shape
    if sum(sections) != d // 2:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to "
                         f"head_dim/2 = {d // 2}")
    inv = rope_freqs(d, theta, device=x.device)              # [D/2]
    stream_of = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.as_tensor(sections, device=x.device))          # [D/2]
    ang_streams = positions.float()[..., None] * inv         # [B, 3, S, D/2]
    idx = stream_of.view(1, 1, 1, -1).expand(b, 1, s, d // 2)
    ang = ang_streams.gather(1, idx)[:, 0]                   # [B, S, D/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)


def text_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """Text-only M-RoPE positions, the three streams equal: ``[B, S] →
    [B, 3, S]``."""
    return positions[:, None, :].expand(positions.shape[0], 3,
                                        positions.shape[1])
