"""qwen2-72b — dense 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064,
GQA + QKV bias [arXiv:2407.10671; hf]."""
from .common import ModelConfig, smoke_of

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv=8, d_ff=29568, vocab=152064,
    head_dim=128, rope_theta=1e6, qkv_bias=True,
)
SMOKE = smoke_of(CONFIG)
