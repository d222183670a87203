"""Config helpers (port of ``repro/configs/common.py``, dense, SSM and
hybrid families)."""
from __future__ import annotations

import dataclasses

from repro_torch.models.ssm import SSMConfig
from repro_torch.models.transformer import ModelConfig

__all__ = ["ModelConfig", "SSMConfig", "smoke_of"]


def smoke_of(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (the reference's
    widths: 2 layers, d_model 64, 4/2 heads of 16, d_ff 128, vocab 512, a
    sliding window of 16 where there is one; a stack with SSD blocks gets
    8 SSD heads of 16, d_state 16 and chunk 16, and a hybrid one 8 query
    heads over 2 KV heads)."""
    if cfg.moe is not None:
        raise NotImplementedError("the MoE family is not ported yet")
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
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, head_dim=16, expand=2,
                              d_conv=4, n_groups=1, chunk=16)
        kw["n_heads"] = 8   # d_inner 128 / head_dim 16
        kw["n_kv"] = 8 if cfg.family == "ssm" else 2
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)
