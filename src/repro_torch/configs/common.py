"""Config helpers (port of ``repro/configs/common.py``, dense family)."""
from __future__ import annotations

import dataclasses

from repro_torch.models.transformer import ModelConfig

__all__ = ["ModelConfig", "smoke_of"]


def smoke_of(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (the reference's
    widths: 2 layers, d_model 64, 4/2 heads of 16, d_ff 128, vocab 512)."""
    if cfg.moe is not None or cfg.ssm is not None:
        raise NotImplementedError("MoE and SSM families are not ported yet")
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=max(1, min(cfg.n_kv, 2)),
        d_ff=128,
        vocab=512,
        head_dim=16,
        n_patches=8 if cfg.n_patches else 0,
        feature_dim=32,
        loss_chunk=32,
        attn_block_k=32,
        sliding_window=16 if cfg.sliding_window else 0,
        remat=False,
    )
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)
