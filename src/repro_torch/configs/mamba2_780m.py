"""Mamba-2 780M: SSD, attention-free [arXiv:2405.21060; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,                 # attention-free
    n_kv_heads=0,
    d_ff=0,                    # no MLP: SSD block only
    vocab_size=50280,
    tie_embeddings=True,
    ssm_state=128,
    ssm_expand=2,              # d_inner = 3072 -> 48 SSD heads of dim 64
    ssm_head_dim=64,
    ssm_chunk=256,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    tie_embeddings=True,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=16,
    dtype="float32",
    remat="none",
)
