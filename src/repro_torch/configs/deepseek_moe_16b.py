"""deepseek-moe-16b — 28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400,
MoE: 2 shared + 64 routed top-6, fine-grained [arXiv:2401.06066; hf]."""
from .common import ModelConfig, MoEConfig, smoke_of

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv=16, d_ff=1408, vocab=102400,
    head_dim=128, rope_theta=1e4,
    moe=MoEConfig(n_routed=64, top_k=6, n_shared=2, d_expert=1408,
                  capacity_factor=1.25, groups=16),
)
SMOKE = smoke_of(CONFIG)
