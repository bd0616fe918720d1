"""StableLM-2 1.6B [hf:stabilityai/stablelm-2-1_6b; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,             # MHA
    d_head=64,
    d_ff=5632,
    vocab_size=100352,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="stablelm-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=160,
    vocab_size=512,
    dtype="float32",
    remat="none",
)
