"""Serving layer of the port: token generation (``ServeEngine``)."""
from repro_torch.serve.engine import ServeEngine

__all__ = ["ServeEngine"]
