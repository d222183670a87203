"""qwen2-vl-2b — VLM backbone 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, M-RoPE, tied embeddings [arXiv:2409.12191; hf].
The vision tower is a stub, as in the reference: a batch carries
precomputed ``patch_embeds`` for the first 256 positions."""
from .common import ModelConfig, smoke_of

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv=2, d_ff=8960, vocab=151936,
    head_dim=128, rope_theta=1e6, qkv_bias=True,
    mrope=True, mrope_sections=(16, 24, 24),
    frontend="vision", n_patches=256, tie_embeddings=True,
)
SMOKE = smoke_of(CONFIG, mrope_sections=(2, 3, 3))
