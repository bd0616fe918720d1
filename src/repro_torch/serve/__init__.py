"""Serving layer of the port: token generation (``ServeEngine``) and
continuous-batching recoloring (``ColoringFrontend``, ``ColoringService``)."""
from repro_torch.serve.coloring import (
    AdmissionError,
    ColoringFrontend,
    ColoringRequest,
    ColoringService,
    ServiceStats,
    Ticket,
    as_request,
)
from repro_torch.serve.engine import ServeEngine

__all__ = [
    "AdmissionError",
    "ColoringFrontend",
    "ColoringRequest",
    "ColoringService",
    "ServeEngine",
    "ServiceStats",
    "Ticket",
    "as_request",
]
