"""Model zoo of the port: the serving path of ``repro.models``.

One generic LM assembled from :class:`ModelConfig` serves every family of
``configs``: dense and MoE decoders, Mamba-2's SSD blocks, Hymba's
parallel attention and SSD heads, the VLM's cross-attention layers and the
audio encoder's frame frontend, with ``repro``'s parameter paths, layouts
and dtypes (``params_from_numpy`` carries a ``repro`` parameter tree
across).  Training (``lm_loss``, remat) is not ported yet.
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill,
)

__all__ = ["ModelConfig", "init_params", "forward", "prefill", "decode_step",
           "init_cache"]
