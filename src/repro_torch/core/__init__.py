"""Core library: the paper's distributed speculate-and-iterate coloring.

Public API:
  - color_distributed / color_single_device: distance-1 coloring over the
    stacked part axis on one device (``simulate`` engine)
  - plan.ColoringPlan: device state uploaded once, many requests
  - backend: ``reference`` (plain PyTorch) / ``cuda`` (hand-written kernels)
  - exchange: ghost-exchange strategies (``all_gather``)
  - validate: proper-coloring checkers
"""
from repro_torch.core.backend import BACKENDS, LocalBackend, get_backend, list_backends
from repro_torch.core.distributed import ColoringResult, color_distributed, color_single_device
from repro_torch.core.exchange import EXCHANGES, get_exchange, list_exchanges
from repro_torch.core.plan import ColoringPlan
from repro_torch.core.validate import is_proper_d1, num_colors

__all__ = [
    "BACKENDS",
    "EXCHANGES",
    "ColoringPlan",
    "ColoringResult",
    "LocalBackend",
    "color_distributed",
    "color_single_device",
    "get_backend",
    "get_exchange",
    "is_proper_d1",
    "list_backends",
    "list_exchanges",
    "num_colors",
]
