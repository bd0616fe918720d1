"""Hymba 1.5B: parallel attn+mamba heads, sliding-window attention
[arXiv:2411.13676; hf].  Simplifications noted in DESIGN.md: SWA on all
layers (paper keeps 3 global-attn layers), no learnable meta tokens."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab_size=32001,
    sliding_window=2048,
    parallel_ssm=True,
    ssm_state=16,
    ssm_expand=2,              # d_inner = 3200 -> 50 SSD heads of dim 64
    ssm_head_dim=64,
    ssm_chunk=256,
    shard_attn_heads=False,    # 25 % 16 != 0
    shard_ssm_heads=False,     # 50 % 16 != 0
)

SMOKE = ModelConfig(
    name="hymba-smoke",
    family="hybrid",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    sliding_window=16,
    parallel_ssm=True,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=16,
    dtype="float32",
    remat="none",
)
