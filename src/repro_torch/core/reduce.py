"""Distributed iterative color reduction (Culberson-style class rebuild).

Sarıyüce et al. ("On Distributed Graph Coloring with Iterative
Recoloring") show a few distributed recoloring passes cut color counts
substantially; Culberson's iterated greedy is the sequential ancestor:
re-run greedy processing *whole color classes* of the previous coloring
in a new order, and the color count can never grow (a vertex processed in
the ``j``-th class sees colored neighbors only in earlier classes, so by
induction its first-fit color is at most ``j``).  Class merges make it
shrink.

This module is the distributed analogue, built on the plan layer:

* each **pass** ranks the current color classes with a pluggable
  **order** (``reverse`` / ``largest_first`` / ``least_used_first`` — a
  registry like backends/exchanges, extend with :func:`register_order`),
  then rebuilds the coloring class-by-class: superstep ``j`` activates
  the vertices of the ``j``-th ranked class and re-runs the existing
  loop via ``ColoringPlan.run(colors0=partial, color_mask=members)``.
  Already-rebuilt classes are frozen and constrain the active class to
  small colors (their cross-partition colors are visible from round 0
  via the plan's ``ghost0`` input); unprocessed classes are still
  uncolored and constrain nothing.  A class of a proper coloring is
  independent (in the problem's conflict graph), so supersteps converge
  without conflict rounds.
* the per-pass class selection — histogram, order scores, class ranking,
  per-vertex superstep index — runs on the plan's device in a
  :class:`ReductionPlan`, cached in the same
  :class:`~repro_torch.core.plan.PlanCache` as ``ColoringPlan`` entries
  (``ReduceKey``).
* passes iterate until the budget or until a pass stops improving; the
  result carries the colors-by-pass trajectory *and* the measured
  per-pass exchange payloads.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.distributed import ColoringResult
from repro_torch.core.plan import (
    ColoringPlan,
    PlanCache,
    default_plan_cache,
    get_plan,
    resolve_device,
)
from repro_torch.core.quality import color_histogram_device
from repro_torch.core.registry import Registry
from repro_torch.core.validate import num_colors
from repro_torch.graph.partition import PartitionedGraph

__all__ = [
    "ORDERS",
    "ReduceKey",
    "ReductionPlan",
    "ReductionResult",
    "ReductionStats",
    "get_order",
    "get_reduce_plan",
    "list_orders",
    "reduce_colors",
    "reduce_colors_batch",
    "register_order",
]


# ---------------------------------------------------------------------------
# Pluggable class orders (registry, like backends/exchanges).
# ---------------------------------------------------------------------------

def _score_reverse(color, hist):
    """Highest color first — Culberson's classic reverse pass."""
    del hist
    return color.to(torch.float32)


def _score_largest_first(color, hist):
    """Biggest class first (ties -> lower color first, stable sort)."""
    del color
    return hist.to(torch.float32)


def _score_least_used_first(color, hist):
    """Smallest class first: tries to empty the rare colors into the
    bulk classes rebuilt later."""
    del color
    return -hist.to(torch.float32)


ORDERS: Registry = Registry(
    "order",
    {
        "reverse": _score_reverse,
        "largest_first": _score_largest_first,
        "least_used_first": _score_least_used_first,
    },
)


def register_order(name: str, score_fn) -> None:
    """Register a class-order heuristic.

    ``score_fn(color, hist) -> float32 scores`` over the ``(cap,)`` color
    axis (int32 tensors on the plan's device); higher scores are rebuilt
    earlier within a pass.  Ties process lower colors first (stable sort).
    Note the :class:`ReduceKey` caches by *name*: re-registering a
    different function under an existing name leaves stale plans in any
    live cache.
    """
    ORDERS.register(name, score_fn)


def list_orders() -> list[str]:
    """Sorted registered order names (drives the CLI choices)."""
    return ORDERS.names()


def get_order(order: str):
    return ORDERS.resolve(order)


# ---------------------------------------------------------------------------
# The reduction plan: class selection on the device, cached beside plans.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReduceKey:
    """Everything the selection depends on; ``device`` as in ``PlanKey``."""

    n_global: int               # colors array length
    cap: int                    # histogram capacity
    order: str
    device: str


@dataclasses.dataclass
class ReductionStats:
    """Probes with ``PlanStats``' meaning: ``traces`` counts builds of the
    selection program (once per plan), ``compiles`` / ``compile_ms`` the
    first ``select`` whole."""

    traces: int = 0
    selects: int = 0
    passes: int = 0
    reduce_ms: float = 0.0      # total wall time inside reduce_colors
    compiles: int = 0
    compile_ms: float = 0.0


class ReductionPlan:
    """Frozen static half of the class-selection step; see module docstring.

    One selection per ``(n_global, cap, order, device)``: histogram, order
    scores, class ranking and the per-vertex superstep index, on the
    key's device.  ``select`` feeds only the dynamic colors array.
    """

    def __init__(self, key: ReduceKey):
        self.key = key
        self.stats = ReductionStats()
        self.device = torch.device(key.device)
        score_fn = get_order(key.order)
        cap = key.cap

        def fn(colors):
            hist = color_histogram_device(colors, cap)
            present = hist > 0
            color = torch.arange(cap, dtype=torch.int32, device=colors.device)
            score = torch.where(present, score_fn(color, hist), -torch.inf)
            # Colors, ranked; the stable sort puts ties at the lower color,
            # as jnp.argsort does.
            seq = torch.argsort(-score, stable=True)
            rank = torch.empty_like(color).scatter_(0, seq, color)
            rank = torch.where(present, rank, -1)
            vrank = torch.where(colors > 0,
                                rank[colors.clamp(0, cap - 1).to(torch.int64)], -1)
            return hist, present.sum(), vrank

        self._fn = fn
        self.stats.traces += 1

    def select(self, colors: np.ndarray):
        """Rank the classes of ``colors``: ``(hist, n_colors, vrank)``.

        ``vrank[v]`` is the superstep at which vertex ``v``'s current
        class is rebuilt (``-1`` = uncolored); the pass then runs
        supersteps ``0 .. n_colors-1`` with ``color_mask = vrank == j``.
        """
        t0 = time.perf_counter()
        colors = torch.from_numpy(np.asarray(colors, np.int32)).to(self.device)
        hist, n_colors, vrank = self._fn(colors)
        out = hist.cpu().numpy(), int(n_colors), vrank.cpu().numpy()
        if self.stats.selects == 0:
            self.stats.compiles += 1
            self.stats.compile_ms += (time.perf_counter() - t0) * 1e3
        self.stats.selects += 1
        return out

    # Cached alongside ColoringPlans: report the (tiny) pinned footprint.
    @property
    def nbytes(self) -> int:
        return 4 * (self.key.n_global + 2 * self.key.cap)


def _cap_for(max_color: int) -> int:
    """Histogram capacity: power of two above the initial color count, so
    every pass of a shrinking coloring reuses one plan."""
    cap = 32
    while cap <= max_color + 1:
        cap *= 2
    return cap


def get_reduce_plan(n_global: int, cap: int, order: str,
                    cache: PlanCache | None | bool = None,
                    device=None) -> ReductionPlan:
    """Fetch-or-build a :class:`ReductionPlan` through a plan cache.

    Same cache semantics as :func:`~repro_torch.core.plan.get_plan`:
    ``None`` / ``True`` → the process-wide default cache (``ReduceKey``
    entries sit alongside ``PlanKey`` ones), a :class:`PlanCache` → that
    cache, ``False`` → a fresh uncached plan.  ``device``: ``None`` means
    ``"cuda"``.
    """
    get_order(order)                    # fail fast on unknown orders
    key = ReduceKey(n_global=int(n_global), cap=int(cap), order=order,
                    device=str(resolve_device(device)))
    if cache is False:
        return ReductionPlan(key)
    target = cache if isinstance(cache, PlanCache) else default_plan_cache()
    return target.get_or_build(key, lambda: ReductionPlan(key))


# ---------------------------------------------------------------------------
# The reduction driver.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReductionResult:
    """Outcome of :func:`reduce_colors` — final coloring + trajectory."""

    colors: np.ndarray          # (n_global,) best coloring found
    n_colors: int
    initial_n_colors: int
    improved: bool              # n_colors < initial_n_colors
    passes_run: int             # passes attempted (incl. final non-improving)
    colors_by_pass: list        # [initial, after pass 1, ...] attempted counts
    comm_bytes_by_pass: list    # measured exchange payload spent per pass
    rounds_by_pass: list        # loop rounds spent per pass (0 = conflict-free)
    exchanges_by_pass: list     # exchange count per pass (supersteps + rounds)
    converged: bool             # every superstep's loop converged
    order: str
    problem: str

    @property
    def comm_bytes_total(self) -> int:
        return int(sum(self.comm_bytes_by_pass))

    def merged_result(self, base: ColoringResult) -> ColoringResult:
        """Fold the reduction into ``base`` (the pre-reduction result):
        final colors/count, summed rounds + measured comm, so downstream
        consumers see one end-to-end ``ColoringResult``.

        The base run's per-round trajectory does not extend across
        reduction supersteps, so ``comm_bytes_by_round`` is dropped
        (``None``) and ``comm_bytes_per_round`` becomes the mean over
        *all* exchanges — base rounds plus every superstep; the per-pass
        split stays available here in :attr:`comm_bytes_by_pass`.
        """
        total = base.comm_bytes_total + self.comm_bytes_total
        n_exchanges = base.rounds + 1 + int(sum(self.exchanges_by_pass))
        return dataclasses.replace(
            base,
            colors=self.colors,
            n_colors=self.n_colors,
            rounds=base.rounds + int(sum(self.rounds_by_pass)),
            converged=base.converged and self.converged,
            comm_bytes_total=total,
            comm_bytes_per_round=total // max(n_exchanges, 1),
            comm_bytes_by_round=None,
            comm_bytes_by_level=None,
        )


def reduce_colors(
    pg_or_plan: PartitionedGraph | ColoringPlan,
    result: ColoringResult | np.ndarray,
    *,
    passes: int = 2,
    order: str = "reverse",
    problem: str = "d1",
    recolor_degrees: bool = True,
    backend: str = "reference",
    exchange: str = "all_gather",
    engine: str = "auto",
    max_rounds: int = 64,
    cache: PlanCache | None | bool = None,
    color_mask: np.ndarray | None = None,
    device=None,
) -> ReductionResult:
    """Reduce the color count of a finished coloring by iterative
    distributed recoloring.

    pg_or_plan: the partitioned topology — or an already-built
    :class:`~repro_torch.core.plan.ColoringPlan` for it (then ``problem``
    / ``backend`` / ``exchange`` / ``engine`` / ``max_rounds`` /
    ``device`` come from the plan and the keyword values are ignored).

    result: the coloring to improve — a ``ColoringResult`` or a raw
    ``(n_global,)`` color array.  It must be proper for the plan's
    problem; reduction preserves properness and never increases the
    color count (each pass rebuilds the coloring class-by-class, so the
    classic iterated-greedy bound applies).

    passes: budget; iteration stops early when a pass stops improving.
    order: class-rebuild order per pass (see :data:`ORDERS`).

    color_mask: optional (n_global,) bool — reduce only this vertex
    subset; everything outside keeps its input color exactly.  Classes
    are ranked over the masked vertices only, and each pass rebuilds just
    their memberships against the frozen rest.  Frozen neighbors carry
    arbitrary colors, so the per-pass iterated-greedy bound no longer
    applies — never-increase is instead enforced by accepting only
    improving passes.

    device: ``None`` means ``"cuda"``; pass ``"cpu"`` to run on the CPU.
    """
    if isinstance(pg_or_plan, ColoringPlan):
        plan = pg_or_plan
    else:
        plan = get_plan(
            pg_or_plan, problem=problem, recolor_degrees=recolor_degrees,
            backend=backend, exchange=exchange, engine=engine,
            max_rounds=max_rounds, cache=cache, device=device,
        )
    return reduce_colors_batch(
        plan, [result], passes=passes, order=order, cache=cache,
        color_masks=[color_mask],
    )[0]


def reduce_colors_batch(
    plan: ColoringPlan,
    results,
    *,
    passes: int = 2,
    order: str = "reverse",
    cache: PlanCache | None | bool = None,
    color_masks=None,
    run_many=None,
) -> list[ReductionResult]:
    """Reduce many colorings of one plan, superstep by superstep.

    The driver behind :func:`reduce_colors` (which is the one-element
    case).  Each pass's superstep ``j`` is issued for *every*
    still-improving element at once through ``run_many(requests) ->
    [ColoringResult]``, each request a dict of ``plan.run`` keywords;
    ``run_many=None`` runs them one by one through ``plan.run``.

    Element semantics are *identical* to calling :func:`reduce_colors`
    per element — same trajectories, accounting, and early stopping:
    each superstep's batch holds exactly the elements with that class
    index left to rebuild, and elements that stop improving leave the
    pass loop.

    results / color_masks: per-element ``ColoringResult`` (or raw colors
    array) and optional ``(n_global,)`` bool masks (see
    :func:`reduce_colors`); returns one :class:`ReductionResult` each.
    The class selection runs on the plan's device.
    """
    t0 = time.perf_counter()
    problem = plan.problem
    if run_many is None:
        run_many = lambda reqs: [plan.run(**r) for r in reqs]  # noqa: E731
    n = len(results)
    if color_masks is None:
        color_masks = [None] * n
    if len(color_masks) != n:
        raise ValueError(
            f"{len(color_masks)} color_masks for {n} results")

    colors, masks = [], []
    for e, result in enumerate(results):
        c = np.asarray(
            result.colors if isinstance(result, ColoringResult) else result,
            np.int32)
        if c.shape != (plan.n_global,):
            raise ValueError(
                f"colors shape {c.shape} != (n_global,) = ({plan.n_global},)")
        m = color_masks[e]
        if m is not None:
            m = np.asarray(m, bool)
            if m.shape != c.shape:
                raise ValueError(
                    f"color_mask shape {m.shape} != colors {c.shape}")
        colors.append(c)
        masks.append(m)

    initial = [num_colors(c) for c in colors]
    rplans = [
        get_reduce_plan(plan.n_global,
                        _cap_for(int(c.max()) if c.size else 0), order,
                        cache=cache, device=plan.device)
        for c in colors
    ]

    best = list(colors)
    best_n = list(initial)
    colors_by_pass = [[i] for i in initial]
    comm_by_pass = [[] for _ in range(n)]
    rounds_by_pass = [[] for _ in range(n)]
    exchanges_by_pass = [[] for _ in range(n)]
    converged = [True] * n
    passes_run = [0] * n
    improving = [bn > 0 for bn in best_n]
    for _ in range(max(passes, 0)):
        act = [e for e in range(n) if improving[e]]
        if not act:
            break
        # Rank classes over the reducible vertices only; frozen vertices
        # get vrank == -1 (never rebuilt) and keep their colors in acc.
        n_classes, vrank, acc = {}, {}, {}
        pass_comm = dict.fromkeys(act, 0)
        pass_rounds = dict.fromkeys(act, 0)
        pass_exchanges = dict.fromkeys(act, 0)
        for e in act:
            m = masks[e]
            _, n_classes[e], vrank[e] = rplans[e].select(
                best[e] if m is None else np.where(m, best[e], 0))
            # On shard_map every rank must rebuild the same classes in the
            # same order, or the ranks would run different supersteps.
            plan.check_ranks_agree(vrank[e].tobytes(), "class selection")
            acc[e] = (np.zeros_like(best[e]) if m is None
                      else np.where(m, 0, best[e]))
        for j in range(max(n_classes[e] for e in act)):
            sub = [e for e in act if j < n_classes[e]]  # classes left to do
            rs = run_many([
                {"color_mask": vrank[e] == j, "colors0": acc[e]} for e in sub
            ])
            for e, r in zip(sub, rs):
                acc[e] = r.colors
                pass_comm[e] += r.comm_bytes_total
                pass_rounds[e] += r.rounds
                pass_exchanges[e] += r.rounds + 1
                converged[e] &= r.converged
        for e in act:
            passes_run[e] += 1
            rplans[e].stats.passes += 1
            new_n = num_colors(acc[e])
            colors_by_pass[e].append(new_n)
            comm_by_pass[e].append(pass_comm[e])
            rounds_by_pass[e].append(pass_rounds[e])
            exchanges_by_pass[e].append(pass_exchanges[e])
            if new_n >= best_n[e]:
                improving[e] = False    # no improvement: budget unspent
            else:
                best[e], best_n[e] = acc[e], new_n

    dt = (time.perf_counter() - t0) * 1e3
    distinct = list({id(r): r for r in rplans}.values())
    for rplan in distinct:              # split so the totals sum to wall time
        rplan.stats.reduce_ms += dt / len(distinct)
    return [
        ReductionResult(
            colors=best[e],
            n_colors=best_n[e],
            initial_n_colors=initial[e],
            improved=best_n[e] < initial[e],
            passes_run=passes_run[e],
            colors_by_pass=colors_by_pass[e],
            comm_bytes_by_pass=comm_by_pass[e],
            rounds_by_pass=rounds_by_pass[e],
            exchanges_by_pass=exchanges_by_pass[e],
            converged=converged[e],
            order=order,
            problem=problem,
        )
        for e in range(n)
    ]
