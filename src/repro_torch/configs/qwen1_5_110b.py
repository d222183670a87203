"""qwen1.5-110b — dense 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias [hf:Qwen/Qwen1.5-0.5B (family); hf]."""
from .common import ModelConfig, smoke_of

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv=8, d_ff=49152, vocab=152064,
    head_dim=128, rope_theta=1e6, qkv_bias=True,
)
SMOKE = smoke_of(CONFIG)
