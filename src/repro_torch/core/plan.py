"""Plan/executor split: compile-once coloring plans behind a keyed LRU cache.

The paper's motivating workload is *repeated* coloring: scientific codes
recolor the same mesh topology every timestep.  This module splits
``color_distributed`` into:

* :class:`ColoringPlan` — the frozen static half: the partitioned
  topology's fingerprint (:attr:`PartitionedGraph.signature`), the
  host-built device-state tables (:func:`cached_device_state`), the
  exchange strategy's prepared tables (``ExchangeStrategy.prepare``), all
  uploaded to the plan's device once, and the loop program for one engine.
  Built once per :class:`PlanKey`.
* :meth:`ColoringPlan.run` — the dynamic half, which uploads only the
  per-request inputs (active mask from ``color_mask``, initial colors
  plus the ghost-color table ``ghost0`` gathered from them, seed).  Warm
  runs rebuild no host state and build no loop program again
  (``plan.stats.traces`` is the probe the tests pin).  Because ``ghost0``
  replicates ``colors0`` onto the ghost slots, a warm start sees frozen
  cross-partition colors from the very first recolor — the property the
  color-reduction subsystem (``repro_torch.core.reduce``) builds on.

:class:`PlanCache` is a keyed LRU over plans; the process-wide default
cache makes every ``color_distributed`` caller warm-path-capable.
``baseline`` / ``jones_plassmann`` read their static state through
:func:`cached_device_state`, so they share the host tables with plans of
the same topology.

The counterpart of ``repro/core/plan.py`` without the slot surface of the
coloring service and without the multi-GPU engine (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import copy
import dataclasses
import time
import weakref
from collections import OrderedDict
from functools import partial

import numpy as np
import torch

from repro_torch.core.backend import LocalBackend, get_backend
from repro_torch.core.distributed import (
    ColoringResult,
    _gather_colors,
    _make_loop,
    _recolor_part,
    _round_part,
    build_device_state,
    state_to_torch,
)
from repro_torch.core.exchange import ExchangeStrategy, get_exchange
from repro_torch.core.validate import num_colors
from repro_torch.graph.csr import SENTINEL
from repro_torch.graph.partition import PAD_GID, PartitionedGraph

__all__ = [
    "ColoringPlan",
    "PlanCache",
    "PlanKey",
    "PlanStats",
    "build_plan",
    "cached_device_state",
    "default_plan_cache",
    "get_plan",
    "plan_key_for",
    "resolve_device",
]


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Everything a plan depends on, and nothing else.

    ``repro``'s key plus ``device``, the resolved device as a string: torch
    places every tensor explicitly, so a CPU plan and a card plan of one
    topology hold different tables and must not share an entry.
    """

    topology: str               # PartitionedGraph.signature
    problem: str
    recolor_degrees: bool
    backend: str
    exchange: str
    engine: str                 # resolved: "simulate" (the only one ported)
    max_rounds: int
    device: str


@dataclasses.dataclass
class PlanStats:
    """Probes for the compile-once contract (pinned by tests).

    Eager PyTorch never traces: ``traces`` counts builds of the plan's
    loop program (the :func:`_make_loop` closure, once per plan), and
    ``compiles`` / ``compile_ms`` book the first :meth:`ColoringPlan.run`
    whole, the run that pays the one-time costs (the kernel libraries'
    first load, the caching allocator's first blocks).
    """

    traces: int = 0             # builds of the loop program
    runs: int = 0               # plan.run() invocations
    build_ms: float = 0.0       # static-half cost (state, prepare, upload)
    last_run_ms: float = 0.0
    compiles: int = 0           # first runs (one per plan)
    compile_ms: float = 0.0     # their wall time


# --------------------------------------------------------------------------
# Host-side device-state cache (shared with baseline / Jones-Plassmann).
# --------------------------------------------------------------------------

_STATE_CACHE: OrderedDict[tuple[str, str], dict[str, np.ndarray]] = OrderedDict()
_STATE_CACHE_MAX = 16


def cached_device_state(pg: PartitionedGraph, problem: str) -> dict[str, np.ndarray]:
    """LRU-cached :func:`build_device_state` keyed by (topology, problem).

    The returned dict (and its arrays) is shared — callers must treat it
    as read-only and copy the dict before merging extra tables.
    """
    key = (pg.signature, problem)
    st = _STATE_CACHE.get(key)
    if st is None:
        st = build_device_state(pg, problem)
        _STATE_CACHE[key] = st
        while len(_STATE_CACHE) > _STATE_CACHE_MAX:
            _STATE_CACHE.popitem(last=False)
    else:
        _STATE_CACHE.move_to_end(key)
    return st


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``.  A CUDA device without a card raises: the port
    never falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is false); "
            "pass device='cpu' to run on the CPU")
    return dev


def _resolve_engine(engine: str) -> str:
    """``"auto"`` → ``"simulate"``; any other name is returned as it is.

    ``repro`` resolves ``"auto"`` to ``"shard_map"`` when there are at
    least ``n_parts > 1`` devices.  The port's multi-GPU engine is not
    ported yet (an explicit ``"shard_map"`` raises at plan build), so
    ``"auto"`` gives ``"simulate"`` on every host, one card or eight.
    """
    return "simulate" if engine == "auto" else engine


def _simulate_only(engine: str) -> None:
    if engine != "simulate":
        raise NotImplementedError(
            f"engine {engine!r} is not ported yet (ROADMAP.md, queue 1)")


def _plan_key(pg, *, problem, recolor_degrees, backend, exchange, engine,
              max_rounds, device) -> PlanKey:
    """The one key constructor (build_plan and the cache lookup share it).

    ``backend``/``exchange`` are resolved to their canonical instance
    names, so a registry alias and its instance hash to the same key.
    """
    return PlanKey(
        topology=pg.signature, problem=problem,
        recolor_degrees=recolor_degrees,
        backend=get_backend(backend).name,
        exchange=get_exchange(exchange).name,
        engine=_resolve_engine(engine),
        max_rounds=max_rounds, device=str(resolve_device(device)),
    )


# --------------------------------------------------------------------------
# The plan.
# --------------------------------------------------------------------------

class ColoringPlan:
    """Frozen static half of a distributed coloring; see module docstring.

    Build with :func:`build_plan` / :func:`get_plan`, execute with
    :meth:`run`.  Called directly, it builds its host state afresh
    (``state_cache=False``); without ``key`` it makes its key on first
    read (see :attr:`key`).

    The exchange strategy's ``prepare`` tables are uploaded with the rest
    of the device state; its loop state (``init_state``) is made on the
    plan's device for every request.  A strategy that ``requires_slab``
    raises ``ValueError`` on a partition whose ghosts are not all on
    parts p±1.
    """

    def __init__(self, pg: PartitionedGraph, *, problem: str = "d1",
                 recolor_degrees: bool = True,
                 backend: str | LocalBackend = "reference",
                 exchange: str | ExchangeStrategy = "all_gather",
                 max_rounds: int = 64, device=None,
                 key: PlanKey | None = None, state_cache: bool = False):
        t0 = time.perf_counter()
        self.device = resolve_device(device)
        if key is not None:
            _simulate_only(key.engine)
        self._key = key
        self._key_of = None if key is not None else partial(
            _plan_key, pg, problem=problem, recolor_degrees=recolor_degrees,
            backend=backend, exchange=exchange, engine="simulate",
            max_rounds=max_rounds, device=self.device)
        self.stats = PlanStats()
        self.problem = problem
        self.recolor_degrees = recolor_degrees
        self.max_rounds = max_rounds
        self.n_parts = pg.n_parts
        self.n_local = pg.n_local
        self.n_global = pg.n_global
        self._vertex_gid = pg.vertex_gid
        self._real = pg.vertex_gid != PAD_GID
        self._gids = np.clip(pg.vertex_gid, 0, pg.n_global - 1)
        # Ghost gid gather tables: initial ghost colors are a per-request
        # input derived from colors0.
        self._ghost_real = pg.ghost_gid != SENTINEL
        self._ghost_gids = np.clip(pg.ghost_gid, 0, pg.n_global - 1)
        # Copy the strategy so plans never share prepare()-written state.
        self._strategy = copy.copy(get_exchange(exchange))
        if self._strategy.requires_slab and not pg.halo_neighbors_ok():
            raise ValueError(f"{self._strategy.name} exchange requires slab "
                             "partitions (ghosts on p±1 only)")
        self._backend = get_backend(backend)

        # The cached dict is shared: copy it before popping and merging.
        st_np = dict(cached_device_state(pg, problem) if state_cache
                     else build_device_state(pg, problem))
        # active0 is the per-request input that color_mask varies.
        self._active0 = st_np.pop("active0")
        # Route plans are colored on the plan's own device.
        st_np.update(self._strategy.prepare(pg, st_np, device=self.device))
        self._st = state_to_torch(st_np, self.device)

        step_kw = dict(problem=problem, recolor_degrees=recolor_degrees,
                       backend=self._backend)
        st = self._st
        self._loop = _make_loop(
            partial(_recolor_part, st, **step_kw),
            partial(_round_part, st, **step_kw),
            partial(self._strategy.stacked, st),
            torch.sum,
            max_rounds=max_rounds,
        )
        self.stats.traces += 1
        self.stats.build_ms = (time.perf_counter() - t0) * 1e3

    def request_inputs(self, color_mask=None, colors0=None, seed=None):
        """Host-side per-request inputs ``(colors0, ghost0, active0, seed)``.

        Stacked ``(P, ...)`` numpy arrays.  ``ghost0`` replicates
        ``colors0`` onto each part's ghost slots, so warm starts see frozen
        cross-partition colors in the very first recolor.
        """
        active0 = self._active0
        if color_mask is not None:
            active0 = active0 & np.asarray(color_mask, bool)[self._gids]
        if colors0 is None:
            c0 = np.zeros((self.n_parts, self.n_local), np.int32)
            g0 = np.zeros(self._ghost_gids.shape, np.int32)
        else:
            colors0 = np.asarray(colors0, np.int32)
            c0 = np.where(self._real, colors0[self._gids], 0)
            g0 = np.where(self._ghost_real, colors0[self._ghost_gids], 0)
        return c0, g0, active0, np.int32(0 if seed is None else seed)

    def run(self, color_mask=None, colors0=None, seed=None) -> ColoringResult:
        """Execute one recoloring request.

        color_mask: optional (n_global,) bool — color only this subset.
        colors0: optional (n_global,) int32 — initial colors (vertices
        outside ``color_mask`` keep theirs, constraining the active set).
        seed: reserved per-request input; the built-in backends are
        deterministic and ignore it.

        No host-side state rebuild: only the three request inputs are
        uploaded.
        """
        t0 = time.perf_counter()
        c0, g0, active0, _ = self.request_inputs(color_mask, colors0, seed)
        dev = self.device
        colors, rounds, conf, total, nbytes = self._loop(
            torch.from_numpy(c0).to(dev), torch.from_numpy(g0).to(dev),
            torch.from_numpy(active0).to(dev),
            torch.zeros(self._st["ghost_real"].shape, dtype=torch.bool, device=dev),
            self._strategy.init_state(self._st),
        )
        res = self._result(colors, rounds, conf, total, nbytes)
        dt = (time.perf_counter() - t0) * 1e3
        if self.stats.runs == 0:
            self.stats.compiles += 1
            self.stats.compile_ms += dt
        self.stats.runs += 1
        self.stats.last_run_ms = dt
        return res

    def _result(self, colors, rounds, conf, total, nbytes) -> ColoringResult:
        by_level = nbytes.cpu().numpy()[: rounds + 1]
        by_round = by_level.sum(axis=1)
        gathered = _gather_colors(self, colors.cpu().numpy())
        return ColoringResult(
            colors=gathered,
            rounds=int(rounds),
            converged=bool(int(conf) == 0),
            n_colors=num_colors(gathered),
            total_conflicts=int(total),
            comm_bytes_per_round=int(by_round.mean()) if by_round.size else 0,
            problem=self.problem,
            n_parts=self.n_parts,
            backend=self._backend.name,
            exchange=self._strategy.name,
            comm_bytes_total=int(by_round.sum()),
            comm_bytes_by_round=by_round.astype(np.int64),
            comm_bytes_by_level=by_level.astype(np.int64),
        )

    @property
    def key(self) -> PlanKey:
        """The plan's :class:`PlanKey`.

        A plan built outside a cache (``build_plan``, ``cache=False``, or
        called directly) makes it on first read: the key hashes the whole
        topology (``pg.signature``), which such a plan may never look up.
        Until then the plan holds its ``PartitionedGraph``.
        """
        if self._key is None:
            self._key, self._key_of = self._key_of(), None
        return self._key

    # _gather_colors only needs .n_global / .vertex_gid.
    @property
    def vertex_gid(self):
        return self._vertex_gid

    @property
    def nbytes(self) -> int:
        """Bytes this plan pins while cached: its device tensors
        (``numel() * element_size()``) and the host gather tables of the
        request inputs."""
        st = sum(v.numel() * v.element_size() for v in self._st.values())
        host = sum(int(a.nbytes) for a in
                   (self._active0, self._gids, self._ghost_gids,
                    self._real, self._ghost_real, self._vertex_gid))
        return st + host


# --------------------------------------------------------------------------
# Keyed LRU plan cache.
# --------------------------------------------------------------------------

class PlanCache:
    """LRU cache of plans keyed by their frozen key dataclass.

    Holds :class:`ColoringPlan` entries keyed by :class:`PlanKey` and
    (keyed alongside them) the reduction subsystem's
    :class:`~repro_torch.core.reduce.ReductionPlan` entries keyed by
    ``ReduceKey`` — any hashable key with a ``.nbytes``-reporting plan
    works.  Eviction is LRU, bounded by entry count (``maxsize``) and
    optionally by pinned bytes (``max_bytes``): cached plans pin their
    state tables, so a sweep over many large topologies can otherwise hold
    every table on the device.  The most recent entry always survives,
    even when it alone exceeds ``max_bytes``.
    """

    def __init__(self, maxsize: int = 16, max_bytes: int | None = None):
        self.maxsize = maxsize
        self.max_bytes = max_bytes
        self.hits = 0
        self.misses = 0
        self._plans: OrderedDict = OrderedDict()
        self._evict_listeners: list = []        # weakrefs to callables

    def __len__(self) -> int:
        return len(self._plans)

    def __contains__(self, key) -> bool:
        return key in self._plans

    def keys(self):
        """Keys from least- to most-recently used."""
        return list(self._plans)

    def plans(self):
        """Snapshot of cached plan objects, least- to most-recently used;
        does not touch LRU order."""
        return list(self._plans.values())

    def clear(self) -> None:
        items = list(self._plans.items())
        self._plans.clear()
        for key, plan in items:
            self._notify_evicted(key, plan)

    def add_evict_listener(self, listener) -> None:
        """Call ``listener(key, plan)`` whenever an entry leaves the cache.

        Held by *weak* reference: dropping the owner of the listener
        unregisters it, so the cache never keeps a dead owner alive.
        """
        self._evict_listeners.append(weakref.ref(listener))

    def _notify_evicted(self, key, plan) -> None:
        live = []
        for ref in self._evict_listeners:
            fn = ref()
            if fn is not None:
                live.append(ref)
                fn(key, plan)
        self._evict_listeners = live

    @property
    def total_bytes(self) -> int:
        """Pinned bytes across all cached plans."""
        return sum(int(getattr(p, "nbytes", 0)) for p in self._plans.values())

    def _evict(self) -> None:
        while len(self._plans) > self.maxsize:
            self._notify_evicted(*self._plans.popitem(last=False))
        if self.max_bytes is not None:
            while len(self._plans) > 1 and self.total_bytes > self.max_bytes:
                self._notify_evicted(*self._plans.popitem(last=False))

    def get_or_build(self, key, builder):
        plan = self._plans.get(key)
        if plan is not None:
            self.hits += 1
            self._plans.move_to_end(key)
            return plan
        self.misses += 1
        plan = builder()
        self._plans[key] = plan
        self._evict()
        return plan


_DEFAULT_CACHE = PlanCache(maxsize=16)


def default_plan_cache() -> PlanCache:
    """The process-wide cache used when ``cache=None`` is passed."""
    return _DEFAULT_CACHE


def plan_key_for(
    pg: PartitionedGraph,
    *,
    problem: str = "d1",
    recolor_degrees: bool = True,
    backend: str | LocalBackend = "reference",
    exchange: str | ExchangeStrategy = "all_gather",
    engine: str = "auto",
    max_rounds: int = 64,
    device=None,
) -> PlanKey:
    """The :class:`PlanKey` a ``get_plan`` call with these arguments uses,
    without building anything."""
    return _plan_key(pg, problem=problem, recolor_degrees=recolor_degrees,
                     backend=backend, exchange=exchange, engine=engine,
                     max_rounds=max_rounds, device=device)


def build_plan(
    pg: PartitionedGraph,
    *,
    problem: str = "d1",
    recolor_degrees: bool = True,
    backend: str | LocalBackend = "reference",
    exchange: str | ExchangeStrategy = "all_gather",
    engine: str = "auto",
    max_rounds: int = 64,
    device=None,
    state_cache: bool = True,
) -> ColoringPlan:
    """Build a fresh plan: exchange prepare, upload and the loop program,
    plus the host state tables (shared via :func:`cached_device_state`
    unless ``state_cache=False`` forces a cold rebuild).

    device: ``None`` means ``"cuda"``; pass ``"cpu"`` to run on the CPU.
    The plan makes its key on first read (see :attr:`ColoringPlan.key`).
    """
    _simulate_only(_resolve_engine(engine))
    return ColoringPlan(pg, problem=problem, recolor_degrees=recolor_degrees,
                        backend=backend, exchange=exchange,
                        max_rounds=max_rounds, device=device,
                        state_cache=state_cache)


def get_plan(
    pg: PartitionedGraph,
    *,
    problem: str = "d1",
    recolor_degrees: bool = True,
    backend: str | LocalBackend = "reference",
    exchange: str | ExchangeStrategy = "all_gather",
    engine: str = "auto",
    max_rounds: int = 64,
    device=None,
    cache: PlanCache | None | bool = None,
) -> ColoringPlan:
    """Fetch-or-build a plan through a :class:`PlanCache`.

    cache: ``None`` or ``True`` → process-wide default; a ``PlanCache`` →
    that cache; ``False`` → fully cold: a fresh plan *and* a fresh host
    state build, bypassing :func:`cached_device_state`.  Calls with a
    backend/exchange *instance* (whose configuration the key cannot
    fingerprint) bypass the plan cache but still share host state.

    Cached plans pin their device tensors until evicted (LRU, default 16
    plans) — for sweeps over many large topologies, pass ``cache=False``
    or call ``default_plan_cache().clear()`` between topologies.
    """
    cacheable = (
        cache is not False
        and isinstance(backend, str)
        and isinstance(exchange, (str, type(None)))
    )
    if not cacheable:
        return build_plan(
            pg, problem=problem, recolor_degrees=recolor_degrees,
            backend=backend, exchange=exchange, engine=engine,
            max_rounds=max_rounds, device=device, state_cache=cache is not False)
    key = _plan_key(pg, problem=problem, recolor_degrees=recolor_degrees,
                    backend=backend, exchange=exchange, engine=engine,
                    max_rounds=max_rounds, device=device)
    target = cache if isinstance(cache, PlanCache) else _DEFAULT_CACHE
    return target.get_or_build(key, partial(
        ColoringPlan, pg, problem=problem, recolor_degrees=recolor_degrees,
        backend=backend, exchange=exchange, max_rounds=max_rounds,
        device=device, key=key, state_cache=True))
