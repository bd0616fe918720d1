"""TinyLlama 1.1B: llama2-arch small [arXiv:2401.02385; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=64,
    d_ff=5632,
    vocab_size=32000,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="tinyllama-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    dtype="float32",
    remat="none",
)
