"""Qwen1.5-32B: QKV bias; 40 heads (not 16-divisible -> MLP-only TP)
[hf:Qwen/Qwen1.5-0.5B family config scaled; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_head=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    shard_attn_heads=False,    # 40 % 16 != 0: attention replicated on TP axis
)

SMOKE = ModelConfig(
    name="qwen1.5-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=192,
    vocab_size=512,
    qkv_bias=True,
    dtype="float32",
    remat="none",
)
