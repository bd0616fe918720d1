"""Model zoo of the port: the dense decoder path of ``repro.models``.

One generic decoder LM assembled from :class:`ModelConfig`, with
``repro``'s parameter paths and layouts (``params_from_numpy`` carries a
``repro`` parameter tree across).  MoE, SSM, hybrid, VLM and audio configs
raise ``NotImplementedError`` until their slices land.
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import decode_step, forward, init_params, prefill

__all__ = ["ModelConfig", "init_params", "forward", "prefill", "decode_step"]
