"""Grok-1 314B: 8-expert top-2 MoE [hf:xai-org/grok-1; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=32768,
    vocab_size=131072,
    act="gelu",
    rope_theta=10_000.0,
    n_experts=8,
    experts_per_token=2,
    moe_shard="tensor",        # 8 experts < 16-way TP: shard d_ff instead
)

SMOKE = ModelConfig(
    name="grok-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=512,
    act="gelu",
    n_experts=4,
    experts_per_token=2,
    capacity_factor=2.0,  # = E/k: dropless for exact serve==train tests
    moe_shard="tensor",
    dtype="float32",
    remat="none",
)
