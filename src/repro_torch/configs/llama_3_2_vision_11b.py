"""Llama-3.2-Vision 11B backbone: cross-attn image layers every 5
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].  Vision frontend is a
STUB: input_specs provides precomputed patch embeddings (task spec)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    cross_attn_every=5,
    vision_seq=1601,           # 1600 patches + cls (stub-provided embeddings)
)

SMOKE = ModelConfig(
    name="llama-vision-smoke",
    family="vlm",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    cross_attn_every=2,
    vision_seq=9,
    dtype="float32",
    remat="none",
)
