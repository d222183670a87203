"""Config helpers and the input-shape registry (port of
``repro/configs/common.py``): ``Shape``, ``SHAPES``, ``shape_applicable``
and ``smoke_of``."""
from __future__ import annotations

import dataclasses

from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import SSMConfig
from repro_torch.models.transformer import ModelConfig

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "Shape", "SHAPES",
           "shape_applicable", "smoke_of"]


@dataclasses.dataclass(frozen=True)
class Shape:
    """One input shape of the dry run: ``seq_len`` × ``global_batch``."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: Shape) -> tuple[bool, str]:
    """``(ok, reason)``: an encoder has no decode step, and ``long_500k``
    needs sub-quadratic attention (an SSM stack, or a hybrid one with a
    sliding window)."""
    if shape.kind == "decode" and not cfg.causal:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k":
        sub_quadratic = cfg.family == "ssm" or (
            cfg.family == "hybrid" and cfg.sliding_window > 0)
        if not sub_quadratic:
            return False, "long_500k needs sub-quadratic attention (full-attention arch)"
    return True, ""


def smoke_of(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (the reference's
    widths: 2 layers, d_model 64, 4/2 heads of 16, d_ff 128, vocab 512, a
    sliding window of 16 where there is one; an MoE stack gets 8 routed
    experts top-2 of width 32, at most one shared, capacity factor 1.5 and
    2 groups; a stack with SSD blocks gets 8 SSD heads of 16, d_state 16
    and chunk 16, and a hybrid one 8 query heads over 2 KV heads)."""
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
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(n_routed=8, top_k=2,
                              n_shared=min(cfg.moe.n_shared, 1),
                              d_expert=32, capacity_factor=1.5, groups=2)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, head_dim=16, expand=2,
                              d_conv=4, n_groups=1, chunk=16)
        kw["n_heads"] = 8   # d_inner 128 / head_dim 16
        kw["n_kv"] = 8 if cfg.family == "ssm" else 2
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)
