"""hymba-1.5b — hybrid 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
parallel attention + Mamba heads per layer, ssm_state=16 [arXiv:2411.13676; hf].
Sliding-window attention (1024) everywhere; Hymba's 3 global-attention layers
are mapped to SWA for the scan-uniform stack (the reference's DESIGN §4)."""
from .common import ModelConfig, SSMConfig, smoke_of

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv=5, d_ff=5504, vocab=32001,
    head_dim=64, rope_theta=1e4, sliding_window=1024,
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, d_conv=4,
                  n_groups=1, chunk=256),
)
SMOKE = smoke_of(CONFIG)
