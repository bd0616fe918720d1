"""Core library: the paper's distributed speculate-and-iterate coloring.

Public API:
  - color_distributed / color_single_device: d1, d1_2gl, d2 and pd2
    coloring over the stacked part axis on one device (``simulate`` engine)
  - plan: ColoringPlan / keyed LRU PlanCache (get_plan) — the static half
    built and uploaded once per topology, warm runs feed only the request
    inputs
  - backend: ``reference`` (plain PyTorch) / ``cuda`` / ``cuda_fused``
    (hand-written kernels)
  - exchange: ghost-exchange strategies (``all_gather``, ``halo``,
    ``delta``, ``sparse_delta``, ``hier_delta``)
  - reduce: distributed iterative color reduction (Culberson-style class
    rebuild over warm plans; pluggable orders) — the quality axis
  - quality: color histograms, balance/skew metrics, trajectories
  - greedy: serial greedy oracle (Alg. 1); baseline (Bozdağ/Zoltan) and
    jones_plassmann: the comparison points
  - validate: proper-coloring checkers
"""
from repro_torch.core.greedy import greedy_d1, greedy_d2, greedy_pd2
from repro_torch.core.validate import (
    color_histogram,
    is_balanced,
    is_proper_d1,
    is_proper_d2,
    is_proper_pd2,
    num_colors,
)
from repro_torch.core.local import local_color_d1, local_color_d2
from repro_torch.core.backend import (
    BACKENDS,
    CudaBackend,
    LocalBackend,
    ReferenceBackend,
    get_backend,
    list_backends,
    register_backend,
)
from repro_torch.core.exchange import (
    EXCHANGES,
    AllGatherExchange,
    DeltaExchange,
    ExchangeStrategy,
    HaloExchange,
    get_exchange,
    list_exchanges,
    register_exchange,
)
from repro_torch.core.distributed import ColoringResult, color_distributed, color_single_device
from repro_torch.core.plan import (
    ColoringPlan,
    PlanCache,
    PlanKey,
    build_plan,
    default_plan_cache,
    get_plan,
    plan_key_for,
)
from repro_torch.core.quality import (
    QualityReport,
    quality_report,
)
from repro_torch.core.reduce import (
    ORDERS,
    ReduceKey,
    ReductionPlan,
    ReductionResult,
    get_order,
    get_reduce_plan,
    list_orders,
    reduce_colors,
    reduce_colors_batch,
    register_order,
)
from repro_torch.core.registry import Registry

__all__ = [
    "greedy_d1",
    "greedy_d2",
    "greedy_pd2",
    "is_proper_d1",
    "is_proper_d2",
    "is_proper_pd2",
    "num_colors",
    "local_color_d1",
    "local_color_d2",
    "color_distributed",
    "color_single_device",
    "ColoringResult",
    "ColoringPlan",
    "PlanCache",
    "PlanKey",
    "build_plan",
    "get_plan",
    "plan_key_for",
    "default_plan_cache",
    "LocalBackend",
    "ReferenceBackend",
    "CudaBackend",
    "BACKENDS",
    "get_backend",
    "list_backends",
    "register_backend",
    "ExchangeStrategy",
    "AllGatherExchange",
    "HaloExchange",
    "DeltaExchange",
    "EXCHANGES",
    "get_exchange",
    "list_exchanges",
    "register_exchange",
    "color_histogram",
    "is_balanced",
    "QualityReport",
    "quality_report",
    "ORDERS",
    "ReduceKey",
    "ReductionPlan",
    "ReductionResult",
    "get_order",
    "get_reduce_plan",
    "list_orders",
    "reduce_colors",
    "reduce_colors_batch",
    "register_order",
    "Registry",
]
