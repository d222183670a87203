"""qwen2-moe-a2.7b — 24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936,
MoE: 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]."""
from .common import ModelConfig, MoEConfig, smoke_of

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv=16, d_ff=1408, vocab=151936,
    head_dim=128, rope_theta=1e6, qkv_bias=True,
    moe=MoEConfig(n_routed=60, top_k=4, n_shared=4, d_expert=1408,
                  capacity_factor=1.25, groups=16),
)
SMOKE = smoke_of(CONFIG)
