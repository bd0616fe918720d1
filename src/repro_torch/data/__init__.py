"""Data pipeline: deterministic, resumable synthetic token batches."""
from repro_torch.data.pipeline import SyntheticLMData

__all__ = ["SyntheticLMData"]
