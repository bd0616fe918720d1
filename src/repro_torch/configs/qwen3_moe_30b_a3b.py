"""Qwen3-30B-A3B: 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=768,                  # per-expert intermediate size
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    n_experts=128,
    experts_per_token=8,
    moe_shard="expert",        # 128 experts / 16-way model axis = 8 per device
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=96,
    vocab_size=512,
    qk_norm=True,
    n_experts=8,
    experts_per_token=2,
    capacity_factor=4.0,  # = E/k: dropless for exact serve==train tests
    moe_shard="expert",
    dtype="float32",
    remat="none",
)
