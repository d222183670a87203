"""hubert-xlarge — audio encoder-only 48L d_model=1280 16H d_ff=5120
vocab=504 (masked-unit targets) [arXiv:2106.07447; unverified].
The conv waveform frontend is a stub, as in the reference: a batch carries
precomputed 512-dim frame ``features``. No decode step (encoder-only)."""
from .common import ModelConfig, smoke_of

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv=16, d_ff=5120, vocab=504,
    head_dim=80, causal=False, norm="ln", act="gelu",
    frontend="audio", feature_dim=512,
)
SMOKE = smoke_of(CONFIG, head_dim=16)
