"""glm4-9b — dense 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552,
RoPE + GQA [hf:THUDM/glm-4-9b; hf]."""
from .common import ModelConfig, smoke_of

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv=2, d_ff=13696, vocab=151552,
    head_dim=128, rope_theta=1e4,
)
SMOKE = smoke_of(CONFIG)
