"""Continuous-batching recoloring service over compile-once coloring plans.

The serving analogue of the paper's timestep workload, grown into a
cross-topology engine: scientific computations recolor the same (or
evolving) structures every timestep, and Sarıyüce et al. show the win
comes from amortizing many sweeps over one graph.  Two layers:

* :class:`ColoringFrontend` — accepts :class:`ColoringRequest` objects
  (``color_mask`` / ``colors0`` / ``seed`` plus scheduling fields
  ``priority`` / ``deadline_ms`` / ``tenant``) for *any* mix of
  topologies.  :meth:`submit` admits a request and returns a
  :class:`Ticket` immediately, pumping in-flight waves opportunistically
  between enqueues; :meth:`drain` (or ``ticket.result()``) runs the
  scheduler to completion.  Each request is routed through the process
  :class:`~repro_torch.core.plan.PlanCache` to the right
  :class:`~repro_torch.core.plan.ColoringPlan` (plans are built on demand
  and evicted under the cache's ``maxsize``/``max_bytes`` budget; the
  frontend's slot programs are dropped with their plan via the cache's
  eviction hook).  Per plan, a **slot scheduler** runs the
  speculate→exchange→detect loop one round at a time over a batched
  request axis: when a slot's request converges it is harvested and
  immediately refilled from the pending queue — finished slots never
  idle waiting for the rest of the bucket to drain.  Every slot's round
  sequence is bit-identical to its solo ``plan.run`` (pinned by tests).
  Slot counts are bucketed to powers of two capped at ``max_batch``, so
  each topology retains O(log max_batch) programs.

  Scheduling is priority/deadline-ordered: within and across plan
  groups, queued requests run highest ``priority`` first, ties broken by
  earliest absolute deadline (``deadline_ms`` is relative to admission),
  then FIFO.  Admission supports backpressure — with ``max_pending`` set,
  a full queue either rejects new work (``admission="reject"`` raises
  :class:`AdmissionError`) or sheds the least-urgent queued request
  (``admission="shed"``; the shed ticket resolves to an
  :class:`AdmissionError`) — and per-tenant in-flight quotas
  (``tenant_quota``), all surfaced in :class:`ServiceStats`.
* :class:`ColoringService` — the familiar same-topology wrapper: it pins
  one plan and serves ``submit`` (solo warm path) and ``run_batch``
  (through the frontend's slot scheduler; batches larger than
  ``max_batch`` stream through refills).

Legacy dict requests (``{"color_mask": ..., "colors0": ..., "seed":
...}``) are still accepted everywhere via :func:`as_request`, which
warns :class:`DeprecationWarning` once per process.

``reduce_passes=N`` turns on the quality axis per request: finished
colorings run through up to N iterative color-reduction passes
(``repro_torch.core.reduce``) before they are returned.  The frontend
batches the reduction too — each pass's supersteps are issued for every
batch element at once through the same slot engine
(:func:`repro_torch.core.reduce.reduce_colors_batch`), so
``reduce_passes=N`` does not serialize a batch.

``stats`` reports the build-vs-execution split: ``cold_runs`` counts
program-build events and ``cold_ms`` their time, while every request's
execution lands in ``warm_ms_total`` / ``warm_requests`` — including the
requests that happened to ride the first batch of a bucket.

The counterpart of ``repro/serve/coloring.py``, with the same names,
behavior and messages, adapted to eager PyTorch:

* **Programs are closures.**  ``_SlotGroup._program`` builds a bucket's
  step or refill closure from the plan's slot surface where ``repro``
  lowers and compiles it ahead of time.  Each build is one ``cold_run``,
  as each compile is in ``repro``; ``cold_ms`` is the build plus the
  program's first execution (the run that pays the kernel libraries'
  first load and the allocator's first blocks, as
  ``PlanStats.compile_ms`` books a plan's first run), and that first
  execution is not booked warm again.
* **``compilation_cache=``** is accepted and does nothing: there is no
  XLA compilation cache to enable (``repro/launch/cache.py`` has no
  counterpart).
* **No sequential fallback.**  Every plan of the port has a slot step,
  so ``repro``'s ``_pump_sequential`` (one solo ``plan.run`` per request
  for plans without one) is left out: a batch always runs through the
  slot engine.
* **``device=``** places every plan (``None`` means ``"cuda"`` and raises
  without a card, as ``resolve_device`` does).
* **``shard_map`` runs one process per part.**  Every rank makes the same
  calls with the same requests, as it must for ``plan.run``, and each
  keeps its own frontend; the slot steps run the exchanges' collectives,
  so every scheduling decision must come out the same on every rank.
  It does: the heap order, shedding, quotas and refills depend only on
  the calls, and a deadline is taken against rank 0's admission clock
  (``ColoringPlan.group_clock_ms``, one small broadcast per admission).
  At each refill the ranks agree on every refilled slot's ``(slot,
  ticket, scheduling key)`` (``ColoringPlan.check_ranks_agree``, one
  all-gather), so callers that submitted in a different order or with
  another priority or deadline raise ``ValueError`` on every rank
  instead of mixing two requests' rows.  The masks are not hashed: like
  ``plan.run``, the engine trusts every rank to pass the same inputs.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import time
import warnings
import weakref

import numpy as np

from repro_torch.core.distributed import ColoringResult
from repro_torch.core.plan import (
    ColoringPlan,
    PlanCache,
    default_plan_cache,
    get_plan,
    resolve_device,
)
from repro_torch.core.reduce import reduce_colors_batch
from repro_torch.graph.partition import PartitionedGraph

__all__ = [
    "AdmissionError",
    "ColoringFrontend",
    "ColoringRequest",
    "ColoringService",
    "ServiceStats",
    "Ticket",
    "as_request",
]


class AdmissionError(RuntimeError):
    """A request was refused (backpressure) or shed from the queue."""


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class ColoringRequest:
    """One recoloring request: the plan inputs plus scheduling fields.

    color_mask: optional (n_global,) bool — recolor only this subset.
    colors0: optional (n_global,) int32 — initial colors (vertices
        outside ``color_mask`` keep theirs, constraining the active set).
    seed: reserved per-request input for randomized backends.
    priority: higher runs earlier (default 0).
    deadline_ms: optional deadline relative to admission, in ms; among
        equal priorities, earlier deadlines schedule first (advisory —
        requests are never dropped for missing a deadline).
    tenant: optional tenant label for quota accounting
        (``ColoringFrontend(tenant_quota=...)`` bounds each tenant's
        in-flight requests; per-tenant counters land in
        ``ServiceStats.by_tenant``).

    Frozen and identity-hashed, so requests are safe dict keys and never
    mutate after admission.
    """

    color_mask: object = None
    colors0: object = None
    seed: object = None
    priority: int = 0
    deadline_ms: float | None = None
    tenant: str | None = None

    def plan_inputs(self) -> dict:
        """The kwargs ``ColoringPlan.run`` / ``request_inputs`` accept."""
        return {"color_mask": self.color_mask, "colors0": self.colors0,
                "seed": self.seed}

    def __repr__(self) -> str:      # ndarray fields make the default huge
        parts = [f"{f.name}={'<set>' if getattr(self, f.name) is not None else None}"
                 for f in dataclasses.fields(self)
                 if f.name in ("color_mask", "colors0")]
        parts += [f"{f.name}={getattr(self, f.name)!r}"
                  for f in dataclasses.fields(self)
                  if f.name not in ("color_mask", "colors0")]
        return f"ColoringRequest({', '.join(parts)})"


_REQUEST_FIELDS = frozenset(f.name for f in dataclasses.fields(ColoringRequest))
_LEGACY_WARNED = False


def as_request(request=None, **kw) -> ColoringRequest:
    """Coerce a request to :class:`ColoringRequest`.

    Accepts a :class:`ColoringRequest` (returned as-is, or with ``kw``
    overrides applied), ``None`` + keyword fields, or a legacy dict —
    the pre-redesign stringly format, converted with a once-per-process
    :class:`DeprecationWarning`.  Unknown keys raise ``TypeError``.
    """
    global _LEGACY_WARNED
    if isinstance(request, ColoringRequest):
        return dataclasses.replace(request, **kw) if kw else request
    merged = dict(request or {})
    merged.update(kw)
    unknown = set(merged) - _REQUEST_FIELDS
    if unknown:
        raise TypeError(
            f"unknown request keys: {sorted(unknown)} "
            f"(allowed: {', '.join(sorted(_REQUEST_FIELDS))})")
    if request is not None and not _LEGACY_WARNED:
        _LEGACY_WARNED = True
        warnings.warn(
            "dict coloring requests are deprecated; pass "
            "repro_torch.serve.ColoringRequest(...) instead",
            DeprecationWarning, stacklevel=3)
    return ColoringRequest(**merged)


class Ticket:
    """Handle for one admitted request: ``done()`` / ``result()``.

    Returned immediately by ``ColoringFrontend.submit``/``enqueue``;
    ``result()`` runs the scheduler until the request completes (and
    raises :class:`AdmissionError` if the request was shed by
    backpressure).  Identity-hashed, so tickets are dict keys — `drain`
    returns ``{ticket: result}``.
    """

    __slots__ = ("id", "request", "_fe", "_state", "_value")

    def __init__(self, fe: "ColoringFrontend", tid: int,
                 request: ColoringRequest):
        self.id = tid
        self.request = request
        self._fe = fe
        self._state = "queued"      # queued | running | done | shed
        self._value = None

    @property
    def state(self) -> str:
        return self._state

    def done(self) -> bool:
        """True once a result (or a shed verdict) is available."""
        return self._state in ("done", "shed")

    def result(self) -> ColoringResult:
        """Block until this request completes; return its result.

        "Blocking" means running the frontend's scheduler inline until
        the ticket resolves (the runtime is single-threaded).
        """
        if self._state in ("queued", "running"):
            self._fe._complete(self)
        if self._state == "shed":
            raise AdmissionError(
                f"request {self.id} was shed by backpressure")
        self._fe._results.pop(self, None)
        self._fe._requests.pop(self, None)
        return self._value

    def __repr__(self) -> str:
        return f"Ticket({self.id}, {self._state})"


def _pow2_bucket(n: int, cap: int) -> int:
    """Power-of-two slot count for ``n`` requests, capped at ``cap``."""
    return max(min(1 << max(n - 1, 0).bit_length(), cap), 1)


def _tenant_bucket() -> dict:
    return {"admitted": 0, "completed": 0, "rejected": 0, "shed": 0}


@dataclasses.dataclass
class ServiceStats:
    """Program-build cost vs execution cost.

    ``cold_runs``/``cold_ms`` count program-build events (a plan's first
    run, a slot-step/refill bucket's build and first execution, or a
    reduction plan's first selection) and nothing else.  Every request's
    execution — including requests that rode a bucket's first batch — is
    attributed to ``warm_ms_total``/``warm_requests``, so
    ``warm_ms_mean`` is the amortized steady-state per-request latency
    from the first request on (the number the plan cache exists to
    minimize).  ``refills`` counts finished slots refilled from the
    pending queue mid-wave — the continuous-batching probe.

    ``rejected``/``shed`` count admission-control outcomes (bounded
    pending queue, tenant quotas); ``by_tenant`` breaks
    admitted/completed/rejected/shed down per tenant label.
    """

    requests: int = 0           # requests admitted
    batches: int = 0            # slot waves started
    refills: int = 0            # finished slots refilled mid-wave
    cold_runs: int = 0          # program-build events
    cold_ms: float = 0.0        # their total time
    warm_ms_total: float = 0.0  # total execution time across all requests
    warm_requests: int = 0      # requests whose execution completed
    rejected: int = 0           # admissions refused (queue full / quota)
    shed: int = 0               # queued requests dropped by shed policy
    by_tenant: dict = dataclasses.field(default_factory=dict)

    @property
    def warm_ms_mean(self) -> float:
        return self.warm_ms_total / max(self.warm_requests, 1)

    def tenant(self, name) -> dict:
        """Per-tenant admission counters (created on first touch)."""
        return self.by_tenant.setdefault(name, _tenant_bucket())


def _compile_totals(cache: PlanCache, *extra_plans) -> tuple[int, float]:
    """Sum (compiles, compile_ms) over every plan the serving path can
    touch: the given plans plus all cached Coloring/Reduction plans."""
    seen = {id(p): p for p in extra_plans}
    for p in cache.plans():
        seen.setdefault(id(p), p)
    n = ms = 0
    for p in seen.values():
        st = getattr(p, "stats", None)
        n += getattr(st, "compiles", 0)
        ms += getattr(st, "compile_ms", 0.0)
    return n, ms


_INTERNAL_TICKETS = itertools.count()
_NO_DEADLINE = math.inf


def _sched_key(req: ColoringRequest, now_ms: float) -> tuple:
    """Heap key: highest priority first, then earliest absolute deadline."""
    deadline = (_NO_DEADLINE if req.deadline_ms is None
                else now_ms + float(req.deadline_ms))
    return (-int(req.priority), deadline)


class _SlotGroup:
    """Slot scheduler for one plan: the continuous-batching executor.

    The group holds a ``(bucket, ...)``-leading carry (the exact loop
    carry plus per-request scalars) and two programs per bucket, built
    from the plan's slot surface (``slot_step`` / ``slot_refill`` /
    ``slot_carry``): ``step`` advances every live slot one
    speculate→exchange→detect round (finished slots are not stepped, so
    their results stay frozen bit-exact), ``refill`` writes a fresh
    request into one slot.

    The pending queue is a priority heap ordered by
    ``(-priority, deadline, fifo)``; shed tickets stay in the heap as
    tombstones and are skipped on pop.

    In-flight work pins ``self.plan``; when the plan cache evicts the
    plan the frontend retires the group and drops it (and its programs)
    once its queue drains.
    """

    def __init__(self, frontend: "ColoringFrontend", plan: ColoringPlan):
        self.fe = frontend
        self.plan = plan
        self.pending: list = []             # heap of (key, seq, ticket, req)
        self._live_pending = 0              # heap entries that are not shed
        self.evicted = False
        self.slots: list = []               # ticket or None per slot
        self.carry = None
        self.bucket = 0
        self._advanced = False              # wave has filled once already
        self._steps: dict[int, callable] = {}
        self._refills: dict[int, callable] = {}
        self._ex_init = None

    def busy(self) -> bool:
        return self._live_pending > 0 or any(t is not None for t in self.slots)

    @property
    def compiled_buckets(self) -> list[int]:
        return sorted(self._steps)

    # -- queue -------------------------------------------------------------

    def push(self, ticket, req: ColoringRequest, key: tuple) -> None:
        heapq.heappush(self.pending, (key, next(self.fe._seq), ticket, req))
        self._live_pending += 1

    def _prune(self) -> None:
        while self.pending and getattr(self.pending[0][2], "_state", "") == "shed":
            heapq.heappop(self.pending)

    def head_key(self):
        """Most urgent live key, or None when nothing is queued."""
        self._prune()
        return self.pending[0][0] if self.pending else None

    def pop(self):
        """The most urgent live entry ``(key, seq, ticket, req)``, or None."""
        self._prune()
        if not self.pending:
            return None
        self._live_pending -= 1
        return heapq.heappop(self.pending)

    def note_shed(self) -> None:
        """A queued ticket was tombstoned by the shed policy."""
        self._live_pending -= 1

    # -- scheduling --------------------------------------------------------

    def pump(self, stats: ServiceStats, *, count: bool = True,
             start_waves: bool = True):
        """Advance one scheduler tick; return finished (ticket, result)s.

        start_waves=False is the opportunistic mode used between
        enqueues: in-flight waves advance, but a new wave only starts
        once a full ``max_batch`` of requests is queued (so eager
        submits don't lock small buckets in).
        """
        if self.carry is None:
            if self._live_pending == 0 or (
                    not start_waves
                    and self._live_pending < self.fe.max_batch):
                return []
            self._start_wave(stats, count=count)
        self._fill_slots(stats, count=count)
        step = self._program(self._steps, self.plan.slot_step, stats)
        t0, cold0 = time.perf_counter(), stats.cold_ms
        self.carry, done = step(self.carry)
        done = np.asarray(done)
        # A new bucket's first step books its time cold, in _program.
        stats.warm_ms_total += max((time.perf_counter() - t0) * 1e3
                                   - (stats.cold_ms - cold0), 0.0)
        finished = []
        for i, ticket in enumerate(self.slots):
            if ticket is not None and done[i]:
                finished.append((ticket, self._extract(i)))
                self.slots[i] = None
                if count:
                    stats.warm_requests += 1
        if not self.busy():
            self.carry = None               # wave drained: release buffers
        return finished

    def execute(self, requests) -> list[ColoringResult]:
        """Synchronously run ``requests`` (plan-input dicts) through the
        slot engine.

        Internal waves (the batched reduction's supersteps): execution
        time is accounted, but request/batch/refill counters are not —
        they track user requests only.  Callers must only use this while
        the group is otherwise idle.
        """
        order = []
        for req in requests:
            ticket = ("internal", next(_INTERNAL_TICKETS))
            order.append(ticket)
            self.push(ticket, ColoringRequest(**req), (0, _NO_DEADLINE))
        got = {}
        while len(got) < len(order):
            for ticket, res in self.pump(self.fe.stats, count=False):
                got[ticket] = res
        return [got[t] for t in order]

    # -- wave machinery ----------------------------------------------------

    def _start_wave(self, stats: ServiceStats, *, count: bool) -> None:
        if self._ex_init is None:
            self._ex_init = self.plan.slot_ex_init()
        self.bucket = _pow2_bucket(self._live_pending, self.fe.max_batch)
        self.carry = self.plan.slot_carry(self.bucket, self._ex_init)
        self.slots = [None] * self.bucket
        self._advanced = False
        if count:
            stats.batches += 1

    def _fill_slots(self, stats: ServiceStats, *, count: bool) -> None:
        if self._live_pending == 0:
            self._advanced = True
            return
        picks = []
        for i in range(self.bucket):
            if self.slots[i] is not None:
                continue
            nxt = self.pop()
            if nxt is None:
                break
            picks.append((i, *nxt))
        if picks:
            # An internal ticket's number is process-wide and may differ
            # between ranks; the heap's seq is the frontend's own.
            self.plan.check_ranks_agree(repr([
                (i, t.id if isinstance(t, Ticket) else None, seq, key)
                for i, key, seq, t, _ in picks]).encode(), "refill")
        for i, _, _, ticket, req in picks:
            self.fe._note_running(ticket)
            c0, g0, a0, _ = self.plan.request_inputs(**req.plan_inputs())
            args = (np.int32(i),) + self.plan.slot_args(c0, g0, a0)
            refill = self._program(
                self._refills, lambda: self.plan.slot_refill(self._ex_init),
                stats)
            self.carry = refill(self.carry, *args)
            self.slots[i] = ticket
            if count and self._advanced:
                stats.refills += 1          # continuous-batching refill
        self._advanced = True

    def _extract(self, i: int) -> ColoringResult:
        c = self.carry
        return self.plan._result(c["colors"][i], int(c["rounds"][i]),
                                 c["conf"][i], c["total"][i], c["bytes"][i])

    # -- programs ----------------------------------------------------------

    def _program(self, table, maker, stats: ServiceStats):
        """The bucket's program from ``table``, built by ``maker`` on a miss.

        A build is one ``cold_run``; its time and its first execution's
        land in ``cold_ms`` (the build replaces ``repro``'s ahead-of-time
        compile, and eager PyTorch pays its one-time costs in the first
        execution).
        """
        fn = table.get(self.bucket)
        if fn is not None:
            return fn
        t0 = time.perf_counter()
        built = maker()
        bucket = self.bucket

        def first(*args):
            try:
                return built(*args)
            finally:
                table[bucket] = built
                stats.cold_ms += (time.perf_counter() - t0) * 1e3

        table[bucket] = first
        stats.cold_runs += 1
        return first


class ColoringFrontend:
    """Cross-topology continuous-batching frontend; see module docstring.

    cache: ``None``/``True`` → the process-wide default
    :class:`PlanCache`; a ``PlanCache`` → that cache (its
    ``maxsize``/``max_bytes`` budget governs which topologies stay
    resident); ``False`` → a private cache (nothing shared with the
    process default).  Reduction plans are resolved through the same
    cache, so they are built once and reused across requests.

    max_pending: optional bound on the queued (admitted but not yet
    running) request count.  When full, ``admission="reject"`` raises
    :class:`AdmissionError` at submit; ``admission="shed"`` drops the
    least-urgent queued request instead (possibly the incoming one —
    its ticket then resolves to :class:`AdmissionError`).
    tenant_quota: optional per-tenant bound on in-flight (admitted,
    unfinished) requests; violations always reject, regardless of the
    shed policy — one tenant's burst must not shed another's work.

    Requests enter with :meth:`submit` (admit + opportunistic pump;
    returns a :class:`Ticket`) or :meth:`enqueue` (admit only) — a
    :class:`~repro_torch.graph.partition.PartitionedGraph` or the signature
    string of a previously seen topology, plus a
    :class:`ColoringRequest` (legacy dicts are converted with a one-time
    deprecation warning) — and complete in :meth:`drain` or
    ``ticket.result()``; :meth:`run_stream` is the
    enqueue-all-then-drain convenience.  Every result is bit-identical
    to a solo ``plan.run`` (plus solo ``reduce_colors`` when
    ``reduce_passes > 0``).

    backend / exchange: names, or instances; with an instance the
    frontend builds one plan per topology and keeps it until
    :meth:`close` (see the module docstring).
    device: where the plans run; ``None`` means ``"cuda"`` and raises
    without a card.
    compilation_cache: accepted for ``repro``'s signature; it does
    nothing.
    """

    def __init__(
        self,
        *,
        problem: str = "d1",
        recolor_degrees: bool = True,
        backend="reference",
        exchange="all_gather",
        engine: str = "auto",
        max_rounds: int = 64,
        cache: PlanCache | None | bool = None,
        max_batch: int = 8,
        reduce_passes: int = 0,
        reduce_order: str = "reverse",
        max_pending: int | None = None,
        admission: str = "reject",
        tenant_quota: int | None = None,
        compilation_cache: bool = True,
        device=None,
    ):
        del compilation_cache
        if isinstance(cache, PlanCache):
            self.cache = cache
        elif cache is False:
            self.cache = PlanCache()
        else:
            self.cache = default_plan_cache()
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if admission not in ("reject", "shed"):
            raise ValueError(
                f"admission must be 'reject' or 'shed', got {admission!r}")
        self.max_batch = int(max_batch)
        self.max_pending = max_pending
        self.admission = admission
        self.tenant_quota = tenant_quota
        self.reduce_passes = reduce_passes
        self.reduce_order = reduce_order
        self._cfg = dict(problem=problem, recolor_degrees=recolor_degrees,
                         backend=backend, exchange=exchange, engine=engine,
                         max_rounds=max_rounds,
                         device=str(resolve_device(device)))
        self.stats = ServiceStats()
        self._pgs: dict[str, PartitionedGraph] = {}
        self._groups: dict = {}             # PlanKey -> _SlotGroup
        self._retired: list = []            # evicted-but-busy groups
        self._seq = itertools.count()       # ticket ids + FIFO heap order
        self._queued = 0                    # admitted, not yet in a slot
        self._tenant_live: dict = {}        # tenant -> in-flight count
        self._requests: dict = {}           # ticket -> (group, request)
        self._results: dict = {}            # ticket -> ColoringResult
        self._unreduced: list = []          # settled, awaiting reduction
        # Weakly-registered eviction hook: the frontend's slot programs
        # are keyed to plan *instances*, so they must die with
        # the plan.  The cache holds only a weakref to this callable —
        # dropping the frontend unregisters it.
        self_ref = weakref.ref(self)

        def _on_evict(key, plan):
            fe = self_ref()
            if fe is not None:
                fe._plan_evicted(key, plan)

        self._evict_hook = _on_evict
        self.cache.add_evict_listener(_on_evict)

    # -- routing -----------------------------------------------------------

    def register(self, pg: PartitionedGraph) -> str:
        """Remember ``pg`` so later requests can route by signature."""
        self._pgs[pg.signature] = pg
        return pg.signature

    def _resolve_pg(self, pg_or_signature) -> PartitionedGraph:
        if isinstance(pg_or_signature, str):
            try:
                return self._pgs[pg_or_signature]
            except KeyError:
                raise KeyError(
                    f"unknown topology signature {pg_or_signature!r}; "
                    "pass the PartitionedGraph once (or register() it) "
                    "before routing by signature") from None
        return self._pgs.setdefault(pg_or_signature.signature,
                                    pg_or_signature)

    def _group_for(self, pg: PartitionedGraph) -> _SlotGroup:
        plan = get_plan(pg, cache=self.cache, **self._cfg)
        group = self._groups.get(plan.key)
        if group is None or group.plan is not plan:
            if group is not None and group.busy():
                self._retired.append(group)     # drains, then dropped
            group = _SlotGroup(self, plan)
            self._groups[plan.key] = group
        return group

    def _plan_evicted(self, key, plan) -> None:
        group = self._groups.get(key)
        if group is not None and group.plan is plan:
            group.evicted = True
            del self._groups[key]
            if group.busy():
                self._retired.append(group)     # in-flight work pins it

    @property
    def n_programs(self) -> int:
        """Slot programs currently retained (all live groups)."""
        return sum(len(g._steps) + len(g._refills)
                   for g in [*self._groups.values(), *self._retired])

    @property
    def pending(self) -> int:
        """Admitted requests not yet running in a slot."""
        return self._queued

    # -- admission ---------------------------------------------------------

    def _admit(self, pg_or_signature, request, request_kw) -> Ticket:
        req = as_request(request, **request_kw)
        pg = self._resolve_pg(pg_or_signature)
        group = self._group_for(pg)
        stats = self.stats
        if self.tenant_quota is not None:
            live = self._tenant_live.get(req.tenant, 0)
            if live >= self.tenant_quota:
                stats.rejected += 1
                stats.tenant(req.tenant)["rejected"] += 1
                raise AdmissionError(
                    f"tenant {req.tenant!r} has {live} requests in flight "
                    f"(quota {self.tenant_quota})")
        # On shard_map rank 0's clock, so the key is the same on every rank.
        key = _sched_key(req, group.plan.group_clock_ms())
        ticket = Ticket(self, next(self._seq), req)
        if self.max_pending is not None and self._queued >= self.max_pending:
            if self.admission == "reject":
                stats.rejected += 1
                stats.tenant(req.tenant)["rejected"] += 1
                raise AdmissionError(
                    f"pending queue full "
                    f"({self._queued}/{self.max_pending} queued)")
            victim = self._worst_queued()
            if victim is None or victim[0] <= key:
                # The incoming request is the least urgent: shed it on
                # arrival (its ticket resolves to AdmissionError).
                ticket._state = "shed"
                stats.shed += 1
                stats.tenant(req.tenant)["shed"] += 1
                return ticket
            self._shed(victim[1], victim[2])
        group.push(ticket, req, key)
        self._queued += 1
        self._tenant_live[req.tenant] = \
            self._tenant_live.get(req.tenant, 0) + 1
        stats.tenant(req.tenant)["admitted"] += 1
        self._requests[ticket] = (group, req)
        stats.requests += 1
        return ticket

    def _worst_queued(self):
        """The least-urgent queued entry: (key, ticket, group) or None."""
        worst = None
        for g in (*self._groups.values(), *self._retired):
            for key, seq, ticket, _ in g.pending:
                if getattr(ticket, "_state", "") != "queued":
                    continue
                if worst is None or (key, seq) > (worst[0], worst[3]):
                    worst = (key, ticket, g, seq)
        return worst

    def _shed(self, ticket: Ticket, group: _SlotGroup) -> None:
        ticket._state = "shed"              # heap entry becomes a tombstone
        group.note_shed()
        self._queued -= 1
        t = ticket.request.tenant
        self._tenant_live[t] = max(self._tenant_live.get(t, 0) - 1, 0)
        self.stats.shed += 1
        self.stats.tenant(t)["shed"] += 1
        self._requests.pop(ticket, None)

    def _note_running(self, ticket) -> None:
        if isinstance(ticket, Ticket):
            ticket._state = "running"
            self._queued -= 1

    # -- request lifecycle -------------------------------------------------

    def enqueue(self, pg_or_signature, request=None, **request_kw) -> Ticket:
        """Admit one request without scheduling; returns its ticket."""
        return self._admit(pg_or_signature, request, request_kw)

    def submit(self, pg_or_signature, request=None, **request_kw) -> Ticket:
        """Admit one request and return its :class:`Ticket` immediately.

        Between submits the frontend pumps opportunistically: in-flight
        waves advance one round, and a new wave starts as soon as a full
        ``max_batch`` of requests is queued for some topology — so a
        steady caller keeps the mesh busy without ever calling ``drain``
        (which remains the run-to-completion point, along with
        ``ticket.result()``).
        """
        ticket = self._admit(pg_or_signature, request, request_kw)
        for group in self._sched_order():
            if group.busy():
                for t, res in group.pump(self.stats, start_waves=False):
                    self._settle(t, res)
        return ticket

    def _sched_order(self) -> list:
        """Groups ordered most-urgent queued request first."""
        groups = [g for g in (*self._groups.values(), *self._retired)]
        idle_key = (math.inf, math.inf)
        return sorted(groups, key=lambda g: g.head_key() or idle_key)

    def _settle(self, ticket, res) -> None:
        self._results[ticket] = res
        if self.reduce_passes > 0:
            self._unreduced.append(ticket)
        else:
            self._finalize(ticket, res)

    def _finalize(self, ticket, res) -> None:
        self._results[ticket] = res
        if isinstance(ticket, Ticket):
            ticket._value = res
            ticket._state = "done"
            t = ticket.request.tenant
            self._tenant_live[t] = max(self._tenant_live.get(t, 0) - 1, 0)
            self.stats.tenant(t)["completed"] += 1

    def _drain_work(self) -> None:
        """Run the scheduler until every admitted request has a result."""
        while True:
            groups = [g for g in self._sched_order() if g.busy()]
            if not groups:
                break
            for group in groups:
                for ticket, res in group.pump(self.stats):
                    self._settle(ticket, res)
        if self.reduce_passes > 0 and self._unreduced:
            tickets, self._unreduced = self._unreduced, []
            self._reduce_finished(tickets)
        self._retired = [g for g in self._retired if g.busy()]

    def _complete(self, ticket: Ticket) -> None:
        self._drain_work()
        if not ticket.done():
            raise RuntimeError(
                f"{ticket!r} did not complete — was it issued by this "
                "frontend?")

    def drain(self, tickets=None) -> dict[Ticket, ColoringResult]:
        """Run the scheduler until every admitted request completes.

        Groups are pumped most-urgent first (the priority/deadline order
        of their queued requests) — a stream of mixed-topology requests
        advances every topology's wave concurrently, and each group
        refills its finished slots from its queue between steps.

        Returns (and consumes) the results for ``tickets``, or for every
        completed request when ``tickets`` is None.  Results not claimed
        by this call stay retained for a later ``drain`` /
        ``ticket.result()``.
        """
        self._drain_work()
        out = {}
        for ticket in (list(self._results) if tickets is None else tickets):
            if ticket in self._results:
                out[ticket] = self._results.pop(ticket)
                self._requests.pop(ticket, None)
        return out

    def run_stream(self, pairs) -> list[ColoringResult]:
        """Enqueue ``(pg_or_signature, request)`` pairs, drain, return the
        results in stream order (other callers' tickets stay claimable)."""
        tickets = [self.enqueue(pg, req) for pg, req in pairs]
        results = self.drain(tickets)
        return [results[t] for t in tickets]

    def close(self) -> None:
        """Drop all groups, programs and routed topologies."""
        self._groups.clear()
        self._retired.clear()
        self._pgs.clear()
        self._requests.clear()
        self._results.clear()
        self._unreduced.clear()
        self._tenant_live.clear()
        self._queued = 0

    # -- batched quality pass ---------------------------------------------

    def _reduce_finished(self, tickets) -> None:
        """Batch-reduce the given *newly completed* colorings (results
        retained from an earlier drain were already reduced once)."""
        by_group: dict = {}
        for ticket in tickets:
            group, req = self._requests[ticket]
            by_group.setdefault(id(group), (group, []))[1].append(
                (ticket, self._results[ticket], req.color_mask))
        n0, ms0 = _compile_totals(self.cache)
        for group, items in by_group.values():
            # The per-pass supersteps run batched through the group's
            # slot engine.
            reds = reduce_colors_batch(
                group.plan, [res for _, res, _ in items],
                passes=self.reduce_passes, order=self.reduce_order,
                cache=self.cache,
                color_masks=[m for _, _, m in items],
                run_many=group.execute,
            )
            for (ticket, res, _), red in zip(items, reds):
                self._finalize(ticket, red.merged_result(res))
        n1, ms1 = _compile_totals(self.cache)
        self.stats.cold_runs += n1 - n0     # reduction plans' first selects
        self.stats.cold_ms += ms1 - ms0


class ColoringService:
    """Serve recoloring requests for one pinned topology.

    A thin same-topology wrapper over :class:`ColoringFrontend`:
    ``submit`` runs the plan's solo warm path, ``run_batch`` routes
    through the frontend's slot scheduler (batches larger than
    ``max_batch`` stream through continuous refills).  The plan is
    pinned for the service's lifetime; bucket programs are keyed to it
    and die with the service (or earlier, if the plan cache evicts the
    plan).  ``stats`` is shared with the
    frontend — one :class:`ServiceStats` covers both paths.
    """

    def __init__(
        self,
        pg: PartitionedGraph,
        *,
        problem: str = "d1",
        recolor_degrees: bool = True,
        backend="reference",
        exchange="all_gather",
        engine: str = "auto",
        max_rounds: int = 64,
        cache: PlanCache | None | bool = None,
        reduce_passes: int = 0,
        reduce_order: str = "reverse",
        max_batch: int = 8,
        device=None,
    ):
        self._frontend = ColoringFrontend(
            problem=problem, recolor_degrees=recolor_degrees,
            backend=backend, exchange=exchange, engine=engine,
            max_rounds=max_rounds, cache=cache, max_batch=max_batch,
            reduce_passes=reduce_passes, reduce_order=reduce_order,
            device=device,
        )
        self._signature = self._frontend.register(pg)
        self.plan = get_plan(pg, cache=self._frontend.cache,
                             **self._frontend._cfg)
        self.engine = self.plan.key.engine
        self.stats = self._frontend.stats
        self.reduce_passes = reduce_passes
        self.reduce_order = reduce_order

    @property
    def buckets(self) -> list[int]:
        """Slot-step bucket sizes built so far (test/bench probe)."""
        group = self._frontend._groups.get(self.plan.key)
        return group.compiled_buckets if group is not None else []

    def _maybe_reduce(self, res: ColoringResult,
                      color_mask=None) -> ColoringResult:
        if self.reduce_passes <= 0:
            return res
        from repro_torch.core.reduce import reduce_colors

        # The request's color_mask is honored end-to-end: reduction only
        # rebuilds classes inside it, so vertices the request froze keep
        # their colors through the quality pass too.  The frontend's
        # cache resolves the ReductionPlan once and reuses it across
        # requests (even when the service was built with ``cache=False``).
        red = reduce_colors(self.plan, res, passes=self.reduce_passes,
                            order=self.reduce_order,
                            cache=self._frontend.cache,
                            color_mask=color_mask)
        return red.merged_result(res)

    # -- request paths -----------------------------------------------------

    def submit(self, request=None, *, color_mask=None, colors0=None,
               seed=None) -> ColoringResult:
        """Execute one recoloring request through the plan's warm path.

        Accepts a :class:`ColoringRequest` (or legacy dict) positionally,
        or the plan-input fields as keywords.
        """
        if request is None:
            req = ColoringRequest(color_mask=color_mask, colors0=colors0,
                                  seed=seed)
        else:
            req = as_request(request)
        t0 = time.perf_counter()
        n0, ms0 = _compile_totals(self._frontend.cache, self.plan)
        res = self._maybe_reduce(self.plan.run(**req.plan_inputs()),
                                 color_mask=req.color_mask)
        wall = (time.perf_counter() - t0) * 1e3
        n1, ms1 = _compile_totals(self._frontend.cache, self.plan)
        stats = self.stats
        if n1 > n0:                         # this request built programs
            stats.cold_runs += n1 - n0
            stats.cold_ms += ms1 - ms0
        stats.warm_ms_total += max(wall - (ms1 - ms0), 0.0)
        stats.warm_requests += 1
        stats.requests += 1
        return res

    def run_batch(self, requests) -> list[ColoringResult]:
        """Execute a batch of requests; results match solo runs bit-for-bit.

        ``requests`` is a sequence of :class:`ColoringRequest` (or legacy
        dicts; an empty dict is a plain full recoloring).  The batch
        streams through the frontend's slot scheduler: up to
        ``max_batch`` slots run concurrently and finished slots
        refill from the remaining requests, so oversized batches keep
        every slot busy.
        """
        reqs = [as_request(r) for r in requests]
        if not reqs:
            return []
        if len(reqs) == 1:
            return [self.submit(reqs[0])]
        fe = self._frontend
        tickets = [fe.enqueue(self._signature, r) for r in reqs]
        results = fe.drain(tickets)
        return [results[t] for t in tickets]
