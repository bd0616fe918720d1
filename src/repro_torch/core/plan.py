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

Two engines run the loop.  ``simulate`` stacks every part on one
device.  ``shard_map`` is the multi-GPU engine: one process per part under
``torch.distributed`` (NCCL between cards, gloo between CPU processes),
every rank calling the same entry point with the same
``PartitionedGraph``.  Rank ``r`` keeps row ``r`` of every device table
as a stack of one part, so the per-part steps and the kernels run on it
unchanged; the exchange is the strategy's ``device`` form and the
conflict count an ``all_reduce``, so every rank runs the same rounds.
The host tables of all parts stay on every rank, and every rank returns
the same :class:`ColoringResult`.

The plan also carries the slot surface of the continuous-batching
service (``repro_torch.serve.coloring``): :attr:`ColoringPlan.raw_step`,
one speculate→exchange→round transition of one request, and
``slot_ex_init`` / ``slot_carry`` / ``slot_step`` / ``slot_refill`` /
``slot_args``, which run it over a carry with one slot per request.  On
``shard_map`` the carry holds the rank's row of every request, the step
runs each live slot's exchange collectives in slot order on every rank,
and one ``all_reduce`` a step sums the live slots' conflict counts.

The counterpart of ``repro/core/plan.py``.
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
import time
import weakref
from collections import OrderedDict
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

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
from repro_torch.core.exchange import (
    ExchangeStrategy,
    all_gather,
    all_sum,
    get_exchange,
    level_split,
)
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
    topology hold different tables and must not share an entry.  On
    ``shard_map`` it is the rank's own device (``cuda:<current device>``).
    """

    topology: str               # PartitionedGraph.signature
    problem: str
    recolor_degrees: bool
    backend: str
    exchange: str
    engine: str                 # resolved: "shard_map" | "simulate"
    max_rounds: int
    device: str


@dataclasses.dataclass
class PlanStats:
    """Probes for the compile-once contract (pinned by tests).

    Eager PyTorch never traces: ``traces`` counts builds of the plan's
    loop program (the :func:`_make_loop` closure, once per plan) and of
    its slot steps (one per :meth:`ColoringPlan.slot_step` call, which the
    service makes once per bucket), and ``compiles`` / ``compile_ms`` book
    the first :meth:`ColoringPlan.run` whole, the run that pays the
    one-time costs (the kernel libraries' first load, the caching
    allocator's first blocks).
    """

    traces: int = 0             # builds of the loop program and slot steps
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


ENGINES = ("auto", "shard_map", "simulate")


def _group_ready() -> bool:
    return dist.is_available() and dist.is_initialized()


def _resolve_engine(engine: str, n_parts: int) -> str:
    """``"auto"`` → ``"shard_map"`` when a process group is initialized and
    its world size equals ``n_parts > 1``, else ``"simulate"``.

    ``repro`` counts the devices it sees; the port counts the ranks of the
    default group, since its engine runs one process per part.  Cards
    without a group give ``"simulate"``.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    if engine == "auto":
        return ("shard_map" if _group_ready() and dist.get_world_size() == n_parts > 1
                else "simulate")
    return engine


def _engine_device(engine: str, device) -> torch.device:
    """The plan's device: on ``shard_map`` a CUDA device without an index is
    the rank's current card (``torch.cuda.set_device(LOCAL_RANK)``)."""
    dev = resolve_device(device)
    if engine == "shard_map" and dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _check_group(n_parts: int, device: torch.device) -> int:
    """The rank of this process in a group that can run a ``shard_map``
    plan of ``n_parts`` parts on ``device``; raises ``ValueError`` else."""
    if not _group_ready():
        raise ValueError(
            "engine 'shard_map' needs an initialized torch.distributed process "
            "group, one process per part: start the processes with torchrun "
            "--nproc-per-node=<parts> and call torch.distributed.init_process_group "
            "(nccl on cards, gloo on the CPU) before building the plan")
    world = dist.get_world_size()
    if world != n_parts:
        raise ValueError(
            f"engine 'shard_map' runs one rank per part: the process group has "
            f"{world} ranks and the partition {n_parts} parts")
    backend, want = str(dist.get_backend()), "nccl" if device.type == "cuda" else "gloo"
    if want not in backend:
        raise ValueError(f"a {backend} process group cannot run a plan on {device}: "
                         f"it needs {want}")
    return dist.get_rank()


def _ranks_agree(token: bytes, what: str, device: torch.device) -> None:
    """Raise ``ValueError`` on every rank unless all ranks hold the same
    ``token`` (one all-gather of its hash).  A disagreement would
    otherwise surface as a hang in a later collective."""
    digest = hashlib.blake2b(token, digest_size=8).digest()
    mine = torch.tensor([int.from_bytes(digest, "little", signed=True)],
                        dtype=torch.int64, device=device)
    hashes = all_gather(mine, dist.get_world_size()).cpu().view(-1)
    if bool((hashes != hashes[0]).any()):
        raise ValueError(f"the ranks derived different {what}s: "
                         f"{[f'{int(h) & (2**64 - 1):016x}' for h in hashes]}")


def _plan_key(pg, *, problem, recolor_degrees, backend, exchange, engine,
              max_rounds, device) -> PlanKey:
    """The one key constructor (build_plan and the cache lookup share it).

    ``backend``/``exchange`` are resolved to their canonical instance
    names, so a registry alias and its instance hash to the same key.
    """
    engine = _resolve_engine(engine, pg.n_parts)
    return PlanKey(
        topology=pg.signature, problem=problem,
        recolor_degrees=recolor_degrees,
        backend=get_backend(backend).name,
        exchange=get_exchange(exchange).name,
        engine=engine,
        max_rounds=max_rounds, device=str(_engine_device(engine, device)),
    )


# --------------------------------------------------------------------------
# The slot engine: one loop transition per request, over a batched carry.
# --------------------------------------------------------------------------

def _tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts / tuples (exchange
    state), with ``rest`` trees of the same structure alongside."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


# Carry leaves with the request axis leading on the device that a slot's
# transition writes back; "conf" and "total" are booked after the step's
# conflict-count sum, "rounds" and "live" are host arrays (see
# ColoringPlan.slot_carry).
_SLOT_ROW = ("colors", "ghost", "lose_l", "lose_g", "bytes")


def _build_transition(exchange, *, backend: LocalBackend, problem: str,
                      recolor_degrees: bool):
    """One speculate→exchange→round transition of one request's carry.

    ``step(st, c) -> (c', conf)`` over one slot of the batched carry (every
    tensor without the request axis, ``rounds`` a host int), where
    ``exchange(st, colors, ex_state)`` is the strategy's ``stacked`` or
    ``device`` form and ``conf`` the conflicts of the parts this process
    holds (every part on ``simulate``, the rank's on ``shard_map``); ``c'``
    lacks ``conf`` and ``total``, which need the group's count.  The layout
    is the state :func:`_make_loop` carries plus the per-request scalars
    the solo loop keeps in locals.  A *fresh* request enters with
    ``rounds == -1``, ``conf == 1``, ``lose_l = active0`` and ``lose_g``
    all false, so its first transition is the solo loop's first step (the
    initial recolor of the request's active set, the exchange, the round)
    and every later one is the loop body.  ``repro`` masks the leading
    recolor of a later transition to an all-false active set, an identity;
    here it is not called.
    """
    step_kw = dict(problem=problem, recolor_degrees=recolor_degrees,
                   backend=backend)

    def step(st, c):
        colors = c["colors"]
        if c["rounds"] < 0:
            colors = _recolor_part(st, colors, c["ghost"], c["lose_l"],
                                   c["lose_g"], **step_kw)
        ghost, nbytes, ex_state = exchange(st, colors, c["ex_state"])
        colors, lose_l, lose_g, conf = _round_part(st, colors, ghost, **step_kw)
        rounds = c["rounds"] + 1
        nbytes_hist = c["bytes"].clone()
        nbytes_hist[rounds] = level_split(nbytes)
        return {"colors": colors, "ghost": ghost, "lose_l": lose_l,
                "lose_g": lose_g, "ex_state": ex_state, "rounds": rounds,
                "bytes": nbytes_hist}, torch.sum(conf)

    return step


def _same(x):
    return x


def _counted(transition, count):
    """:attr:`ColoringPlan.raw_step`: ``transition`` with its conflict count
    summed over the group by ``count`` and booked into ``conf`` / ``total``."""

    def step(st, c):
        new, conf = transition(st, c)
        conf = count(conf)
        new.update(conf=conf, total=c["total"] + conf)
        return new

    return step


def _rank_rows(st_np: dict, rank: int, n_parts: int) -> dict:
    """Row ``rank`` of every stacked table as a stack of one (``v[r:r+1]``);
    0-d constants whole."""
    out = {}
    for k, v in st_np.items():
        v = np.asarray(v)
        if v.ndim and v.shape[0] != n_parts:
            raise ValueError(f"device table {k!r} of shape {v.shape} is not "
                             f"stacked over the {n_parts} parts")
        out[k] = v[rank:rank + 1] if v.ndim else v
    return out


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

    ``engine="shard_map"`` (see the module docstring) is built by every
    rank of the default process group, whose world size must equal
    ``pg.n_parts`` and whose backend must fit the device (``nccl`` for a
    card, ``gloo`` for the CPU); otherwise ``ValueError``.  The build
    all-gathers a hash of the plan's route schedule, so ranks that derived
    different ones raise here instead of hanging in a later round.
    """

    def __init__(self, pg: PartitionedGraph, *, problem: str = "d1",
                 recolor_degrees: bool = True,
                 backend: str | LocalBackend = "reference",
                 exchange: str | ExchangeStrategy = "all_gather",
                 max_rounds: int = 64, device=None, engine: str = "simulate",
                 key: PlanKey | None = None, state_cache: bool = False):
        t0 = time.perf_counter()
        self.engine = key.engine if key is not None else _resolve_engine(
            engine, pg.n_parts)
        self.device = _engine_device(self.engine, device)
        self._rank = (_check_group(pg.n_parts, self.device)
                      if self.engine == "shard_map" else None)
        self._key = key
        self._key_of = None if key is not None else partial(
            _plan_key, pg, problem=problem, recolor_degrees=recolor_degrees,
            backend=backend, exchange=exchange, engine=self.engine,
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
        self._backend = get_backend(backend)
        self._strategy = copy.copy(get_exchange(exchange, self._backend.name))
        if self._strategy.requires_slab and not pg.halo_neighbors_ok():
            raise ValueError(f"{self._strategy.name} exchange requires slab "
                             "partitions (ghosts on p±1 only)")

        # The cached dict is shared: copy it before popping and merging.
        st_np = dict(cached_device_state(pg, problem) if state_cache
                     else build_device_state(pg, problem))
        # active0 is the per-request input that color_mask varies.
        self._active0 = st_np.pop("active0")
        # Route plans are colored on the plan's own device.
        st_np.update(self._strategy.prepare(pg, st_np, device=self.device))
        # The global size of the tables, the same on every rank (repro's
        # sharded plan reports the global size too).
        self._st_bytes = sum(int(v.nbytes) for v in st_np.values())
        step_kw = dict(problem=problem, recolor_degrees=recolor_degrees,
                       backend=self._backend)
        if self._rank is None:
            st = self._st = state_to_torch(st_np, self.device)
            # Every part's conflicts are already in this process's sum.
            form, count = self._strategy.stacked, _same
        else:
            # The first collective of the plan, before any point-to-point
            # transfer (NCCL wants every rank in a group's first call).
            _ranks_agree(repr((
                problem, recolor_degrees, self._backend.name, self._strategy.name,
                self.n_parts, self.n_local, self.n_global, max_rounds,
                self._strategy.route_phases())).encode(), "route plan", self.device)
            st = self._st = state_to_torch(_rank_rows(st_np, self._rank, self.n_parts),
                                           self.device)
            form, count = partial(self._strategy.device, n_parts=self.n_parts), all_sum
        self._loop = _make_loop(
            partial(_recolor_part, st, **step_kw),
            partial(_round_part, st, **step_kw),
            partial(form, st), lambda conf: count(torch.sum(conf)),
            max_rounds=max_rounds)
        self._transition = _build_transition(form, **step_kw)
        self._count = count
        # One request's transition, the group's conflict count included.
        self.raw_step = _counted(self._transition, count)
        self.stats.traces += 1
        self.stats.build_ms = (time.perf_counter() - t0) * 1e3

    @property
    def _rows(self) -> slice:
        """The parts this process holds: all, or its rank's."""
        r = self._rank
        return slice(None) if r is None else slice(r, r + 1)

    def check_ranks_agree(self, token: bytes, what: str) -> None:
        """On ``shard_map``, raise ``ValueError`` unless every rank passes
        the same ``token``; nothing on ``simulate``."""
        if self._rank is not None:
            _ranks_agree(token, what, self.device)

    def group_clock_ms(self) -> float:
        """``time.monotonic()`` in ms; on ``shard_map`` rank 0's, broadcast
        to every rank (one small collective), so a request's deadline gives
        the same scheduling key on every rank."""
        now = time.monotonic() * 1e3
        if self._rank is None:
            return now
        t = torch.tensor([now], dtype=torch.float64, device=self.device)
        dist.broadcast(t, src=0)
        return float(t.item())

    def request_inputs(self, color_mask=None, colors0=None, seed=None):
        """Host-side per-request inputs ``(colors0, ghost0, active0, seed)``.

        Stacked ``(P, ...)`` numpy arrays; on ``shard_map`` the rank's row
        only, ``(1, ...)``.  ``ghost0`` replicates ``colors0`` onto each
        part's ghost slots, so warm starts see frozen cross-partition colors
        in the very first recolor.
        """
        rows = self._rows
        gids, ghost_gids = self._gids[rows], self._ghost_gids[rows]
        active0 = self._active0[rows]
        if color_mask is not None:
            active0 = active0 & np.asarray(color_mask, bool)[gids]
        if colors0 is None:
            c0 = np.zeros(gids.shape, np.int32)
            g0 = np.zeros(ghost_gids.shape, np.int32)
        else:
            colors0 = np.asarray(colors0, np.int32)
            c0 = np.where(self._real[rows], colors0[gids], 0)
            g0 = np.where(self._ghost_real[rows], colors0[ghost_gids], 0)
        return c0, g0, active0, np.int32(0 if seed is None else seed)

    # -- slot-engine surface (continuous batching) -------------------------
    #
    # The service (repro_torch.serve.coloring) runs waves of requests
    # through a carry with one slot per in-flight request and builds its
    # per-bucket step and refill programs from these methods.  ``repro``
    # vmaps the request axis; here the step walks the live slots and runs
    # one transition on each slot's row, a contiguous view the kernels take
    # as it is, so the graph tables are never repeated per request.  On
    # shard_map a slot's row is the rank's part of that request.

    def slot_ex_init(self):
        """One request's exchange state, part axis leading."""
        return self._strategy.init_state(self._st)

    def slot_carry(self, bucket: int, ex_init):
        """All-slots-idle batched carry for a ``bucket``-wide wave.

        ``repro``'s carry, every device leaf with the request axis leading:
        ``colors (B, P, N)`` and ``ghost (B, P, G)`` int32, ``lose_l`` /
        ``lose_g`` bool, each exchange-state leaf ``(B, ...)``, ``conf`` /
        ``total (B,)`` and ``bytes (B, max_rounds + 1, 2)`` int32.  On
        ``shard_map`` ``P`` is 1, the rank's row; ``conf`` and ``total`` are
        the group's, the same on every rank.  Two
        leaves are numpy arrays on the host: ``rounds (B,)``, which the host
        advances as the solo loop's Python counter, and ``live (B,)``, the
        host's copy of ``(conf > 0) & (rounds < max_rounds)`` (the slots
        the next step runs).  Idle slots have ``rounds == max_rounds`` and
        ``conf == 0``, so the step treats them as finished until a refill.
        """
        p = self.n_parts if self._rank is None else 1
        nl, g = self.n_local, self._ghost_gids.shape[1]
        mr, dev = self.max_rounds, self.device

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return {
            "colors": zeros(bucket, p, nl),
            "ghost": zeros(bucket, p, g),
            "lose_l": zeros(bucket, p, nl, dtype=torch.bool),
            "lose_g": zeros(bucket, p, g, dtype=torch.bool),
            "ex_state": _tree_map(
                lambda x: x.expand((bucket,) + x.shape).clone(), ex_init),
            "conf": zeros(bucket),
            "rounds": np.full(bucket, mr, np.int32),
            "total": zeros(bucket),
            "bytes": zeros(bucket, mr + 1, 2),
            "live": np.zeros(bucket, bool),
        }

    def slot_step(self):
        """``step(carry) -> (carry, done)`` over the whole slot batch.

        Runs one transition on each live slot's row, in ascending slot
        order, and writes the new state back into that row; finished and
        idle slots are not touched, which is what ``repro``'s select mask
        gives, bit for bit.  The live slots' conflict counts are then summed
        over the group at once (one ``all_reduce`` of a vector on
        ``shard_map``, where every rank runs the slots' collectives in the
        same order) and booked into ``conf`` / ``total``; one host sync per
        step reads them, so every rank sees the same ``done``, a
        ``(bucket,)`` numpy bool array.  The carry is updated in place (as
        ``repro``'s program donates it).
        """
        trans, count, st, mr = self._transition, self._count, self._st, self.max_rounds
        self.stats.traces += 1

        def step(carry):
            live, confs = np.flatnonzero(carry["live"]), []
            for i in live:
                row = {k: carry[k][i] for k in _SLOT_ROW}
                row["ex_state"] = _tree_map(lambda x: x[i], carry["ex_state"])
                row["rounds"] = int(carry["rounds"][i])
                new, conf = trans(st, row)
                for k in _SLOT_ROW:
                    carry[k][i] = new[k]
                _tree_map(lambda buf, x: buf[i].copy_(x), carry["ex_state"],
                          new["ex_state"])
                carry["rounds"][i] = new["rounds"]
                confs.append(conf)
            if confs:
                conf = count(torch.stack(confs))
                for j, i in enumerate(live):
                    carry["conf"][i] = conf[j]
                    carry["total"][i] += conf[j]
            conf = carry["conf"].cpu().numpy()          # the step's host sync
            carry["live"] &= (conf > 0) & (carry["rounds"] < mr)
            return carry, ~carry["live"]

        return step

    def slot_refill(self, ex_init):
        """``refill(carry, slot, c0, g0, a0) -> carry`` writing a fresh
        request into one slot (fresh-slot sentinel: ``rounds=-1, conf=1``);
        every leaf of the slot's row is reset."""

        def refill(carry, slot, c0, g0, a0):
            i = int(slot)
            carry["colors"][i] = c0
            carry["ghost"][i] = g0
            carry["lose_l"][i] = a0
            carry["lose_g"][i] = False
            _tree_map(lambda buf, init: buf[i].copy_(init), carry["ex_state"],
                      ex_init)
            carry["conf"][i] = 1
            carry["total"][i] = 0
            carry["bytes"][i] = 0
            carry["rounds"][i] = -1
            carry["live"][i] = True
            return carry

        return refill

    def slot_args(self, c0, g0, a0):
        """One request's refill inputs, uploaded to the plan's device."""
        return tuple(torch.from_numpy(x).to(self.device) for x in (c0, g0, a0))

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
        if self._rank is not None:                  # every rank's (1, N) row
            colors = all_gather(colors[0], self.n_parts)
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
        """Bytes this plan pins while cached: its device tables and the host
        gather tables of the request inputs.  On ``shard_map`` the tables'
        global size, the same on every rank (as ``repro`` reports for a
        sharded plan), so every rank's cache evicts alike."""
        host = sum(int(a.nbytes) for a in
                   (self._active0, self._gids, self._ghost_gids,
                    self._real, self._ghost_real, self._vertex_gid))
        return self._st_bytes + host


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
    return ColoringPlan(pg, problem=problem, recolor_degrees=recolor_degrees,
                        backend=backend, exchange=exchange,
                        max_rounds=max_rounds, device=device, engine=engine,
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
