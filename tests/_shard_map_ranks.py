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


def job_matrix(rank, world):
    """The whole matrix on 4 ranks, warm requests on d1, the pd2 rmat case,
    the route plans and the error paths of a group."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.plan import ColoringPlan, build_plan, plan_key_for
    from repro_torch.serve.coloring import ColoringService

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
    errors["slots"] = [
        _raises(NotImplementedError, fn) for fn in (
            sparse.slot_ex_init, lambda: sparse.slot_carry(1, ()), sparse.slot_step,
            lambda: sparse.slot_refill(()), lambda: sparse.slot_args(None, None, None))]
    errors["service"] = _raises(NotImplementedError, lambda: ColoringService(
        pg, engine="shard_map", device="cpu"))
    errors["service_auto"] = _raises(NotImplementedError, lambda: ColoringService(
        pg, device="cpu"))
    cpu = torch.device("cpu")
    errors["agree"] = _raises(ValueError, lambda: plan_mod._ranks_agree(
        b"one route plan", "route plan", cpu))
    errors["disagree"] = _raises(ValueError, lambda: plan_mod._ranks_agree(
        bytes([rank % 2]), "route plan", cpu))
    return out


def job_eight(rank, world):
    """``hier_delta`` with nodes of 2 and 4 parts in both transports, and
    two reduction passes on d1 and d2, on 8 ranks."""
    from repro_torch.core.exchange import HierDeltaExchange
    from repro_torch.core.plan import PlanCache, get_plan
    from repro_torch.core.reduce import reduce_colors

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
    return out


JOBS = {"matrix": job_matrix, "eight": job_eight}


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
