"""Qwen3-32B: qk_norm + GQA [hf:Qwen/Qwen3-8B family; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen3-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    qk_norm=True,
    dtype="float32",
    remat="none",
)
