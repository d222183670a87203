"""mamba2-130m — attention-free SSM 24L d_model=768 vocab=50280,
ssm_state=128, SSD (state-space duality) [arXiv:2405.21060; unverified].
n_heads records the SSD value-head count (d_inner/head_dim = 1536/64 = 24)."""
from .common import ModelConfig, SSMConfig, smoke_of

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=24, n_kv=24, d_ff=0, vocab=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4,
                  n_groups=1, chunk=256),
)
SMOKE = smoke_of(CONFIG)
