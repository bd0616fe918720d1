"""HuBERT X-Large: encoder-only audio transformer [arXiv:2106.07447;
unverified].  Conv waveform frontend is a STUB: input_specs provides
precomputed 512-d frame features (task spec)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_head=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,              # encoder-only
    act="gelu",
    frontend_dim=512,
)

SMOKE = ModelConfig(
    name="hubert-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=160,
    vocab_size=128,
    causal=False,
    act="gelu",
    frontend_dim=24,
    dtype="float32",
    remat="none",
)
