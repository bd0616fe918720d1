"""The rank side of ``tests/test_torch_shard_map.py``: gloo groups of CPU
processes running the port's ``shard_map`` engine.

It imports neither jax nor ``repro``, so each rank starts on torch alone.
:func:`run_group` starts ``world`` ranks of one job; each rank
runs the job and sends back its results (or its traceback), and the
parent kills every rank once its hard limit passes, so a deadlock fails the
test instead of hanging the suite.  The case lists are shared with the
parent, which colors the same cases on the ``simulate`` engine.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.exchange import EXCHANGES
from repro_torch.graph.generators import hex_mesh, rmat
from repro_torch.graph.partition import partition_graph

PROBLEMS = ("d1", "d1_2gl", "d2", "pd2")
BACKENDS = ("reference", "cuda", "cuda_fused")
# (exchange, transport keywords): the sparse two in both transports.
TRANSPORTS = (("all_gather", None), ("halo", None), ("delta", None),
              ("sparse_delta", {"ragged": "auto"}), ("sparse_delta", {"ragged": False}),
              ("hier_delta", {"ragged": False}), ("hier_delta", {"ragged": True}))
GROUP_TIMEOUT_S = 60            # a rank's collectives give up after this
JOIN_LIMIT_S = 120              # the parent's hard limit for a whole group


def hex_pg(n_parts):
    return partition_graph(hex_mesh(24, 8, 8), n_parts, second_layer=True)


def rmat_pg():
    return partition_graph(rmat(6, 6, seed=5), 4, strategy="edge_balanced",
                           second_layer=True)


def exchange(name, kw, backend):
    """The named exchange, or an instance in the given transport with the
    scatter a name takes under ``backend``."""
    if kw is None:
        return name
    scatter = "reference" if backend == "reference" else "cuda"
    return EXCHANGES[name](scatter=scatter, **kw)


def case_id(problem, backend, name, kw):
    ragged = "" if kw is None else f"/ragged={kw['ragged']}"
    return f"{problem}/{backend}/{name}{ragged}"


def matrix_cases():
    """Every problem × backend × exchange (``halo`` on d1, the slabs'
    problem), the sparse two in both transports."""
    for problem in PROBLEMS:
        for backend in BACKENDS:
            for name, kw in TRANSPORTS:
                if name != "halo" or problem == "d1":
                    yield problem, backend, name, kw


def warm_inputs(pg, colors, seed=0):
    """A 10% warm request: a random mask and the coloring with it cleared."""
    mask = np.random.default_rng(seed).random(pg.n_global) < 0.1
    return mask, np.where(mask, 0, colors)


def hier_cases():
    for node_size in (2, 4):
        for problem in ("d1", "d2"):
            for ragged in (False, True):
                yield node_size, problem, ragged


def color(pg, problem, backend, ex, engine, **kw):
    from repro_torch.core.distributed import color_distributed

    return color_distributed(pg, problem=problem, backend=backend, exchange=ex,
                             engine=engine, device="cpu", cache=False, **kw)


# ---------------------------------------------------------------------------
# Jobs (every rank runs the same sequence of collectives).
# ---------------------------------------------------------------------------

def _raises(exc, fn):
    """The message of the ``exc`` that ``fn()`` raises (None if none)."""
    try:
        fn()
    except exc as e:
        return str(e)
    return None


SLOT_MASKS = (None, 2, 3)       # run_slots' requests: all, or every k-th gid


def slot_mask(pg, k):
    return None if k is None else np.arange(pg.n_global) % k == 0


def run_slots(plan, ks):
    """``plan``'s slot surface by hand: the requests ``slot_mask(k)`` for
    ``ks`` through a carry of two slots, refilling a slot as soon as it
    finishes; the results in request order."""
    ex = plan.slot_ex_init()
    carry, step, refill = plan.slot_carry(2, ex), plan.slot_step(), plan.slot_refill(ex)
    queue, slots, got = list(enumerate(ks)), [None, None], {}
    while queue or any(s is not None for s in slots):
        for i in range(2):
            if slots[i] is None and queue:
                slots[i], k = queue.pop(0)
                c0, g0, a0, _ = plan.request_inputs(color_mask=slot_mask(plan, k))
                carry = refill(carry, i, *plan.slot_args(c0, g0, a0))
        carry, done = step(carry)
        for i in range(2):
            if slots[i] is not None and done[i]:
                got[slots[i]] = plan._result(carry["colors"][i], int(carry["rounds"][i]),
                                             carry["conf"][i], carry["total"][i],
                                             carry["bytes"][i])
                slots[i] = None
    return [got[j] for j in range(len(ks))]


def job_matrix(rank, world):
    """The whole matrix on 4 ranks, warm requests on d1, the pd2 rmat case,
    the route plans, the slot surface and the service, and the error paths
    of a group."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.plan import ColoringPlan, build_plan, plan_key_for
    from repro_torch.serve.coloring import ColoringRequest, ColoringService

    pg = hex_pg(world)
    out = {"cold": {}, "warm": {}}
    for problem, backend, name, kw in matrix_cases():
        cid = case_id(problem, backend, name, kw)
        out["cold"][cid] = color(pg, problem, backend, exchange(name, kw, backend),
                                 "shard_map")
        if problem == "d1" and backend == "cuda_fused":
            plan = build_plan(pg, backend=backend, exchange=exchange(name, kw, backend),
                              engine="shard_map", device="cpu")
            mask, c0 = warm_inputs(pg, out["cold"][cid].colors)
            out["warm"][cid] = plan.run(color_mask=mask, colors0=c0)
    out["rmat_pd2"] = color(rmat_pg(), "pd2", "cuda_fused", "sparse_delta", "shard_map")

    sparse = build_plan(pg, exchange="sparse_delta", engine="shard_map", device="cpu")
    hier = build_plan(pg, exchange="hier_delta", engine="shard_map", device="cpu")
    out["phases"] = (sparse._strategy.route_phases(), hier._strategy.route_phases())
    out["key"] = plan_key_for(pg, device="cpu")
    out["auto"] = (plan_mod._resolve_engine("auto", world),
                   plan_mod._resolve_engine("auto", world - 1))
    out["nbytes"] = sparse.nbytes

    errors = out["errors"] = {}
    errors["world"] = _raises(ValueError, lambda: ColoringPlan(
        partition_graph(hex_mesh(24, 8, 8), world - 1), engine="shard_map",
        device="cpu"))
    # A gloo group cannot run a card's plan (checked before any card is used).
    saved = torch.cuda.is_available, torch.cuda.current_device
    torch.cuda.is_available, torch.cuda.current_device = (lambda: True), (lambda: 0)
    try:
        errors["backend"] = _raises(ValueError, lambda: build_plan(
            pg, engine="shard_map", device="cuda"))
    finally:
        torch.cuda.is_available, torch.cuda.current_device = saved
    # The slot surface by hand: three requests through two slots, the third
    # a refill, beside their solo runs.
    out["slots"] = (run_slots(sparse, SLOT_MASKS), [
        sparse.run(color_mask=slot_mask(pg, k)) for k in SLOT_MASKS])
    reqs = [ColoringRequest(color_mask=m, colors0=c) for m, c in (
        warm_inputs(pg, out["cold"]["d1/cuda_fused/all_gather"].colors, seed)
        for seed in range(3))]
    svc = ColoringService(pg, backend="cuda_fused", engine="shard_map", device="cpu",
                          max_batch=2)
    out["service"] = (svc.run_batch(reqs), [svc.plan.run(**r.plan_inputs())
                                            for r in reqs], svc.stats.refills)
    # Callers that disagree on the requests' priority, or on their order,
    # raise on every rank at the first refill instead of mixing rows.
    skewed = [dataclasses.replace(r, priority=rank % 2 if i == 0 else 0)
              for i, r in enumerate(reqs)]
    errors["service"] = _raises(ValueError, lambda: ColoringService(
        pg, backend="cuda_fused", engine="shard_map", device="cpu").run_batch(skewed))
    urgent = [dataclasses.replace(reqs[0], priority=1), reqs[1]]
    errors["service_auto"] = _raises(ValueError, lambda: ColoringService(
        pg, device="cpu").run_batch(urgent[::1 if rank % 2 else -1]))
    cpu = torch.device("cpu")
    errors["agree"] = _raises(ValueError, lambda: plan_mod._ranks_agree(
        b"one route plan", "route plan", cpu))
    errors["disagree"] = _raises(ValueError, lambda: plan_mod._ranks_agree(
        bytes([rank % 2]), "route plan", cpu))
    return out


def job_eight(rank, world):
    """``hier_delta`` with nodes of 2 and 4 parts in both transports, two
    reduction passes on d1 and d2, and a frontend stream with a reduction
    pass, on 8 ranks."""
    from repro_torch.core.exchange import HierDeltaExchange
    from repro_torch.core.plan import PlanCache, get_plan
    from repro_torch.core.reduce import reduce_colors
    from repro_torch.serve.coloring import ColoringFrontend

    pg = hex_pg(world)
    out = {"hier": {}, "reduce": {}}
    for node_size, problem, ragged in hier_cases():
        ex = HierDeltaExchange(scatter="cuda", node_size=node_size, ragged=ragged)
        out["hier"][node_size, problem, ragged] = color(
            pg, problem, "cuda_fused", ex, "shard_map")
    cache = PlanCache()
    for problem in ("d1", "d2"):
        plan = get_plan(pg, problem=problem, backend="cuda_fused", engine="shard_map",
                        device="cpu", cache=cache)
        res = plan.run()
        out["reduce"][problem] = (res, reduce_colors(plan, res, passes=2, cache=cache))
    # repro's frontend stream with one reduction pass, on 8 ranks.
    fe = ColoringFrontend(engine="shard_map", device="cpu", cache=PlanCache(),
                          reduce_passes=1)
    out["stream_reduce"] = fe.run_stream(requests(reduce_pairs(pg)))
    return out


def stream_pairs():
    """``repro``'s frontend scenario on 4 parts: ``hex_mesh(12, 6, 6)`` and
    an edge-balanced ``rmat(8, 6)``, both with a second layer, 12 requests
    alternating between them, every third round of two masked to the even
    gids.  ``(pg, color_mask)`` pairs."""
    pgs = (partition_graph(hex_mesh(12, 6, 6), 4, second_layer=True),
           partition_graph(rmat(8, 6, seed=5), 4, strategy="edge_balanced",
                           second_layer=True))
    return [(pg, None if i % 3 != 2 else np.arange(pg.n_global) % 2 == 0)
            for i in range(6) for pg in pgs]


def reduce_pairs(pg8):
    """``repro``'s reduction stream on 8 parts: ``pg8`` and an edge-balanced
    ``rmat(8, 6)``, each with and without an even-gid mask, twice."""
    pgs = (pg8, partition_graph(rmat(8, 6, seed=5), 8, strategy="edge_balanced",
                                second_layer=True))
    return [(pg, m) for _ in range(2) for pg in pgs
            for m in (None, np.arange(pg.n_global) % 2 == 0)]


def requests(pairs, **kw):
    from repro_torch.serve.coloring import ColoringRequest

    return [(pg, ColoringRequest(color_mask=m, **kw)) for pg, m in pairs]


SKEW_DEADLINES = (200.0, 20.0, 100.0, 5.0, None)    # ms after admission
SKEW_S = 0.03           # rank r sleeps r * SKEW_S before every other submit
CLI_RUNS = {            # the CLI's service modes on the group (--device cpu)
    "repeat": ["--graph", "hex:12,6,6", "--backend", "cuda_fused", "--repeat", "3"],
    "stream": ["--stream", "hex:6,4,4|grid:12,12", "--requests", "6",
               "--backend", "cuda_fused", "--exchange", "sparse_delta"],
    "baseline": ["--graph", "rmat:8,6", "--baseline", "--reduce-passes", "1"],
}


def cli_lines(name, engine):
    """The lines ``run_one`` prints for ``CLI_RUNS[name]`` on 4 parts."""
    from repro_torch.launch import color as cli

    ap = cli.parser()
    args = ap.parse_args(CLI_RUNS[name] + ["--parts", "4", "--device", "cpu",
                                           "--engine", engine])
    lines = []
    cli.run_one(ap, args, lines.append)
    return lines


def job_slots(rank, world):
    """The service on the engine (4 ranks): ``repro``'s frontend stream
    through refills, a stream with deadlines whose ranks admit at skewed
    times (with rank 0's clock, then with each rank's own), the service
    under ``engine="auto"`` and the CLI's service modes."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.plan import PlanCache, get_plan
    from repro_torch.serve.coloring import ColoringFrontend, ColoringService

    out, cache = {}, PlanCache()
    pairs = requests(stream_pairs())
    fe = ColoringFrontend(engine="shard_map", device="cpu", cache=cache, max_batch=2)
    out["stream"] = fe.run_stream(pairs)
    out["stream_solo"] = [get_plan(pg, engine="shard_map", device="cpu", cache=cache)
                          .run(**r.plan_inputs()) for pg, r in pairs]
    s = fe.stats
    out["stream_stats"] = (s.refills, s.batches, s.requests, s.warm_requests,
                           sorted({g.plan.key.engine for g in fe._groups.values()}))

    pg = pairs[0][0]

    def skewed():
        fe = ColoringFrontend(backend="cuda_fused", exchange="delta", engine="shard_map",
                              device="cpu", cache=cache, max_batch=2)
        tickets = []
        for i, deadline in enumerate(SKEW_DEADLINES):
            if i % 2:
                time.sleep(rank * SKEW_S)
            tickets.append(fe.submit(pg, deadline_ms=deadline,
                                     color_mask=slot_mask(pg, i + 2)))
        got = fe.drain(tickets)
        return [got[t] for t in tickets]

    out["skew"] = skewed()
    out["skew_solo"] = [get_plan(pg, backend="cuda_fused", exchange="delta",
                                 engine="shard_map", device="cpu", cache=cache)
                        .run(color_mask=slot_mask(pg, i + 2))
                        for i in range(len(SKEW_DEADLINES))]
    shared = plan_mod.ColoringPlan.group_clock_ms
    plan_mod.ColoringPlan.group_clock_ms = lambda self: time.monotonic() * 1e3
    try:
        out["own_clocks"] = _raises(ValueError, skewed)
    finally:
        plan_mod.ColoringPlan.group_clock_ms = shared

    svc = ColoringService(pg, backend="cuda_fused", exchange="sparse_delta",
                          device="cpu", cache=cache, max_batch=4)
    reqs = [r for _, r in requests((pg, slot_mask(pg, k)) for k in range(2, 7))]
    out["auto"] = (svc.engine, svc.run_batch(reqs),
                   [svc.plan.run(**r.plan_inputs()) for r in reqs], svc.stats.refills)
    out["cli"] = {name: cli_lines(name, "shard_map") for name in CLI_RUNS}
    return out


JOBS = {"matrix": job_matrix, "eight": job_eight, "slots": job_slots}


def rank_main(rank, world, rendezvous, job, results):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{rendezvous}", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            results.put((rank, "ok", JOBS[job](rank, world)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))


def run_group(tmp_dir, world, job):
    """Spawn ``world`` gloo ranks running ``job``; their results by rank.

    Raises ``AssertionError`` with the first rank's traceback when a rank
    fails, or when the group outlives :data:`JOIN_LIMIT_S` (every rank is
    then killed)."""
    # A fork server: a fresh process (not a fork of this one, which may hold
    # jax's threads) that imports torch and this module once; each rank is
    # forked from it, so the ranks do not pay the imports again.
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    results = ctx.Queue()
    rendezvous = os.path.join(str(tmp_dir), f"rendezvous-{job}")
    procs = [ctx.Process(target=rank_main, args=(r, world, rendezvous, job, results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_LIMIT_S
    got = {}
    try:
        while len(got) < world:
            try:
                rank, status, payload = results.get(
                    timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                raise AssertionError(
                    f"{job}: ranks {sorted(set(range(world)) - set(got))} gave no "
                    f"result within {JOIN_LIMIT_S} s") from None
            if status != "ok":
                raise AssertionError(f"{job}: rank {rank} failed:\n{payload}")
            got[rank] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.01))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]
