"""The coloring path: configurations whose ``kind`` is ``"coloring"``.

Set-up makes the configuration's graph from the seed, partitions it with
the port's ``partition_graph``, builds the one plan through the port's plan
cache (``get_plan``) and warms it with one request of the mix's own kind.
The window then drives the mix's entry back to back, one caller in a
closed loop, for ``seconds``; on ``engine: "shard_map"`` every rank of a
process group, one per card, makes the same calls, rank 0's clock ending
the window for all.

A traffic mix (``bench/traffic/*.json``) is read by :class:`Traffic`:

* ``entry``: ``"color_distributed"`` (the port's entry, plan from its
  cache) or ``"plan_run"`` (``get_plan(...).run(color_mask, colors0)``);
* ``recolor_fraction``: the share of vertices a request colors; ``1``
  colors every vertex from nothing (cold), below ``1`` a fresh random
  subset drawn from the seed and the request's index, which starts from
  the previous request's coloring with that subset cleared.

Once the window has closed and the device's peak is read, the program's
state is freed and the plain reference (``bench/reference``) recolors, on
the same device, the inputs of a sample of the window's requests drawn
from the seed, and of the last; in a partial mix also the request before
each, whose answer is its start, so that no compared request starts from
an answer that was not compared itself.  Every number compared must equal
the reference's (limit 0): colors vertex by vertex, rounds, the conflicts
counted, the payload of every exchange, plus the reference's own test that
the coloring is proper and complete.  Cold requests share one input, so
every request's rounds, conflicts, payloads and colors used are compared.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import os
import queue as queue_mod
import shutil
import sys
import tempfile
import threading
import time
import traceback

import numpy as np
import torch

from bench import harness
from bench.reference import work
from bench.reference.coloring import Topology

SAMPLE = 4              # window requests compared besides the last, from the seed
GROUP_WAIT_S = 300      # longest a rank's set-up or window may keep the others
GIB = 2**30


# ---------------------------------------------------------------------------
# Inputs: the graph and the requests.
# ---------------------------------------------------------------------------

def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def make_inputs(config: dict, seed: int, device) -> tuple:
    """The configuration's graph, made by ``bench/gen/<generator>.py`` from
    the seed on ``device``: as ``(n, W)`` numpy neighbour lanes (the
    reference's input) and as the port's CSR ``Graph``.  The device's peak
    is reset after, so that it is the program's."""
    from repro_torch.graph.csr import Graph

    gen = importlib.import_module(f"bench.gen.{config['graph']['generator']}")
    lanes = gen.make(config["graph"], config["n_parts"], seed, device)
    valid = lanes >= 0
    offsets = torch.zeros(lanes.shape[0] + 1, dtype=torch.int64, device=lanes.device)
    torch.cumsum(valid.sum(dim=1), dim=0, out=offsets[1:])
    graph = Graph(n=lanes.shape[0], offsets=offsets.cpu().numpy(),
                  targets=lanes[valid].cpu().numpy(), name="bench")
    ell = lanes.cpu().numpy()
    del lanes, valid, offsets
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    return ell, graph


def _mix(seed: int, k: int) -> int:
    """A 63-bit generator seed for request ``k`` of a run (splitmix64)."""
    x = (seed * 0x9E3779B97F4A7C15 + k + 1) % 2**64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) % 2**64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) % 2**64
    return (x ^ (x >> 31)) >> 1


class Traffic:
    """The general generator of a coloring mix (see the module docstring)."""

    def __init__(self, mix: dict, n: int, seed: int, device):
        self.entry = mix["entry"]
        self.fraction = float(mix["recolor_fraction"])
        if self.entry not in ("color_distributed", "plan_run"):
            raise ValueError(f"unknown entry {self.entry!r}")
        if self.entry == "color_distributed" and self.fraction < 1:
            raise ValueError("color_distributed takes no initial colors: "
                             "a partial recoloring needs entry plan_run")
        self.cold = self.fraction >= 1
        self.n, self.seed, self.device = n, seed, torch.device(device)

    def inputs(self, k: int, prev):
        """``(color_mask, colors0)`` of request ``k``; ``prev`` is the
        previous request's result."""
        if self.cold:
            return None, None
        gen = torch.Generator(device=self.device).manual_seed(_mix(self.seed, k))
        mask = (torch.rand(self.n, generator=gen, device=self.device)
                < self.fraction).cpu().numpy()
        return mask, np.where(mask, 0, prev.colors).astype(np.int32)


# ---------------------------------------------------------------------------
# The program's side: plan, warm-up, window.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Kept:
    """A request kept for the comparison: its index, inputs and result."""
    k: int
    mask: np.ndarray | None
    colors0: np.ndarray | None
    result: object


def _plan_kw(config: dict, device) -> dict:
    return dict(problem=config["problem"], recolor_degrees=config["recolor_degrees"],
                backend=config["backend"], exchange=config["exchange"],
                engine=config["engine"], max_rounds=config["max_rounds"],
                device=str(device))


def summary(res) -> tuple:
    """What every request of one input must repeat."""
    return (res.rounds, res.converged, res.total_conflicts, res.n_colors,
            tuple(int(b) for b in res.comm_bytes_by_round))


def session(pg, n: int, config: dict, mix: dict, *, seed: int, seconds: float,
            trace: bool, device, t_start: float, rank: int = 0) -> dict:
    """Build the plan, warm it, run the window; everything the program gave."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.distributed import color_distributed

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    kw = _plan_kw(config, dev)
    traffic = Traffic(mix, n, seed, dev)
    t0 = time.perf_counter()
    plan = plan_mod.get_plan(pg, **kw)
    sync()
    plan_build_s = time.perf_counter() - t0

    def call(mask, colors0):
        if traffic.entry == "color_distributed":
            return color_distributed(pg, color_mask=mask, **kw)
        return plan_mod.get_plan(pg, **kw).run(color_mask=mask, colors0=colors0)

    # Warm-up: one request of the mix's own kind (a partial one starts from
    # a cold coloring, which is kept as the chain's start).
    start = None if traffic.cold else plan.run()
    warm = traffic.inputs(-1, start)
    prev = call(*warm)
    sync()
    before = Kept(-1, *warm, prev)          # the request whose answer the next starts from
    log(f"rank {rank}: plan {plan_build_s:.3f} s, warm-up "
        f"{time.perf_counter() - t0 - plan_build_s:.3f} s")

    tracer = harness.Tracer(trace, dev)
    saved = {}
    if trace:
        for name in ("request_inputs", "_result", "_loop"):
            saved[name] = getattr(plan, name)
            setattr(plan, name, tracer.wrap(name.strip("_"), saved[name]))
        saved["get_plan"] = plan_mod.get_plan
        plan_mod.get_plan = tracer.wrap("get_plan", saved["get_plan"])
        call = tracer.wrap("request", call)
    if plan.engine == "shard_map":
        torch.distributed.barrier()
        clock = lambda: plan.group_clock_ms() / 1e3             # noqa: E731
    else:
        clock = time.perf_counter
    rng = np.random.default_rng([seed % 2**63, 1])
    kept: list[list[Kept]] = []
    latencies, summaries, colors_used, failed, k, last = [], [], [], 0, 0, []
    t_setup = time.perf_counter()
    try:
        with tracer.window():
            with tracer.quiet():
                clock()                             # every rank has reached here
                end = clock() + seconds
            w0 = time.perf_counter()
            while True:
                with tracer.quiet():
                    if clock() >= end:
                        break
                    with tracer.span(harness.OWN):
                        mask, colors0 = traffic.inputs(k, prev)
                t1 = time.perf_counter()
                try:
                    res = call(mask, colors0)
                except Exception:                   # a request that fails counts
                    traceback.print_exc()
                    failed, res = failed + 1, None
                t2 = time.perf_counter()
                latencies.append(t2 - t1 if res is not None else float("inf"))
                if res is not None:
                    summaries.append(summary(res))
                    colors_used.append(res.n_colors)
                    here = Kept(k, mask, colors0, res)
                    last = [here] if traffic.cold else [before, here]
                    # Reservoir sample of SAMPLE requests, besides the last.
                    j = k if k < SAMPLE else int(rng.integers(0, k + 1))
                    if j < SAMPLE:
                        if j < len(kept):
                            kept[j] = last
                        else:
                            kept.append(last)
                    before, prev = here, res
                k += 1
            w1 = time.perf_counter()
    finally:
        for name, fn in saved.items():
            if name == "get_plan":
                plan_mod.get_plan = fn
            else:
                setattr(plan, name, fn)
    out = {
        "attempted": k, "failed": failed, "latencies": latencies,
        "window_s": w1 - w0, "setup_s": t_setup - t_start,
        "summaries": summaries, "colors_used": colors_used,
        "kept": list({x.k: x for group in kept + [last] for x in group}.values()),
        "start": start, "partition_s": None, "plan_build_s": plan_build_s,
        "plan_table_bytes": plan.nbytes,
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0,
    }
    if trace:
        io = sum(t - s for name, s, t in tracer.spans if name in ("request_inputs", "result"))
        out["record"] = {
            "requests": k, "host_io_s": io / max(k, 1),
            # A request that failed misses every latency limit.
            "latencies": [t if np.isfinite(t) else w1 - w0 for t in latencies],
            "syncs": tracer.syncs if cuda else None,
            "rounds": [s[0] for s in summaries],
            "colors": [s[3] for s in summaries],
            "payload_per_round": [int(np.mean(s[4])) if s[4] else 0 for s in summaries],
            **tracer.device_time(),
        }
    del plan, prev, before, call
    return out


# ---------------------------------------------------------------------------
# The comparison with the reference.
# ---------------------------------------------------------------------------

def judge(ell: np.ndarray, config: dict, prog: dict, device) -> tuple[list, list]:
    """The checks ``[(name, value, limit)]`` and the bytes the algorithm
    needs for each kept request (``work.request_bytes``)."""
    topo = Topology(ell, config["n_parts"], config["problem"],
                    second_layer=config["second_layer"],
                    recolor_degrees=config["recolor_degrees"], device=device)
    differ = {"colors_differ": 0, "improper": 0, "rounds_differ": 0,
              "conflicts_differ": 0, "payload_differ": 0}
    nbytes = []
    cache = {}

    def compare(res, mask, colors0, key, count=True):
        if key in cache:
            ref, need = cache[key]
        else:
            ref = topo.color(colors0, mask, max_rounds=config["max_rounds"])
            need = work.request_bytes(topo, ref) if count else None
            if key is not None:
                cache[key] = ref, need
        if count:
            nbytes.append(need)
        colors = np.asarray(res.colors)
        differ["colors_differ"] = max(differ["colors_differ"],
                                      int((colors != ref.colors).sum()))
        differ["improper"] = max(differ["improper"], topo.improper(colors))
        differ["rounds_differ"] = max(differ["rounds_differ"], abs(res.rounds - ref.rounds)
                                      + int(res.converged != ref.converged))
        differ["conflicts_differ"] = max(differ["conflicts_differ"],
                                         abs(res.total_conflicts - ref.total_conflicts))
        mine, want = np.asarray(res.comm_bytes_by_round, np.int64), ref.bytes_by_round
        size = max(mine.size, want.size)
        gap = np.abs(np.pad(mine, (0, size - mine.size))
                     - np.pad(want, (0, size - want.size))).sum()
        differ["payload_differ"] = max(differ["payload_differ"], int(gap))
        return ref

    cold = bool(prog["kept"]) and prog["kept"][0].mask is None
    for kept in prog["kept"]:
        ref = compare(kept.result, kept.mask, kept.colors0, "cold" if cold else None)
    if prog["start"] is not None:               # the chain's cold start
        compare(prog["start"], None, None, None, count=False)
    checks = [("failed", prog["failed"], 0), *[(k, v, 0) for k, v in differ.items()]]
    if cold:
        # One input: every request's rounds, conflicts, payloads and colors
        # used must be the reference's.
        want = (ref.rounds, ref.converged, ref.total_conflicts, ref.n_colors,
                tuple(int(b) for b in ref.bytes_by_round))
        checks.append(("requests_differ", sum(s != want for s in prog["summaries"]), 0))
    checks.append(("none_compared", int(not prog["kept"]), 0))
    return checks, nbytes


# ---------------------------------------------------------------------------
# One run.
# ---------------------------------------------------------------------------

def _free_program() -> None:
    from repro_torch.core.plan import default_plan_cache

    default_plan_cache().clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _device_info(device, n_chips: int, peak: int) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
    else:
        kind = "cpu"
    return {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
            "count": n_chips, "memory_peak_bytes": int(peak)}


def finish(ell, config, prog, device, *, n_chips, peak, busy_s=None) -> dict:
    """Judge the program's window and shape what ``harness.run_cell`` reads."""
    checks, nbytes = judge(ell, config, prog, device)
    done = prog["attempted"] - prog["failed"]
    out = {
        "attempted": prog["attempted"], "failed": prog["failed"], "checks": checks,
        "end_to_end": {
            "colorings_per_s": done / prog["window_s"] if prog["window_s"] else 0.0,
            "colors_used": float(np.mean(prog["colors_used"])) if done else 0.0,
            "peak_device_gib": peak / GIB,
            "setup_s": prog["setup_s"],
        },
        "device": _device_info(device, n_chips, peak),
    }
    if "record" in prog:
        rec = prog["record"]
        if busy_s is not None:
            rec["busy_s"] = busy_s
        rec.update(chips=n_chips, partition_s=prog["partition_s"], plan_build_s=prog["plan_build_s"],
                   plan_table_bytes=prog["plan_table_bytes"],
                   work_bytes_per_request=float(np.mean(nbytes)) if nbytes else None,
                   peak_bytes_per_s=_peak_bandwidth(out["device"]["kind"]))
        out["record"] = rec
        out["device"].update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        out["breakdown"] = {"device_ops": rec.pop("device_ops"),
                            "idle_gaps": rec.pop("idle_gaps")}
    return out


def _log_window(prog: dict, t0: float) -> None:
    lat, q = prog["latencies"], max(len(prog["latencies"]) // 4, 1)
    log(f"window {prog['window_s']:.3f} s, {prog['attempted']} requests, mean latency "
        f"first / last quarter {np.mean(lat[:q]) * 1e3:.1f} / {np.mean(lat[-q:]) * 1e3:.1f} ms;"
        f" reference and comparison {time.perf_counter() - t0:.3f} s")


def _peak_bandwidth(kind: str) -> float | None:
    """HBM bytes/s of ``kind`` from ``bench/peaks.json`` (None if absent)."""
    peaks = harness.load_json(harness.BENCH / "peaks.json")
    entry = peaks.get(kind)
    return None if entry is None else float(entry["hbm_bytes_per_s"])


def run(*, config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device: str, t_start: float) -> dict:
    if config["engine"] == "shard_map":
        return _run_group(config, traffic, seed, seconds, trace, device, t_start)
    from repro_torch.graph.partition import partition_graph

    t0 = time.perf_counter()
    ell, graph = make_inputs(config, seed, device)
    t1 = time.perf_counter()
    pg = partition_graph(graph, config["n_parts"], second_layer=config["second_layer"])
    partition_s = time.perf_counter() - t1
    log(f"graph {t1 - t0:.3f} s, partition {partition_s:.3f} s")
    prog = session(pg, ell.shape[0], config, traffic, seed=seed, seconds=seconds,
                   trace=trace, device=device, t_start=t_start)
    prog["partition_s"] = partition_s
    peak = prog["peak_bytes"]
    del pg, graph
    _free_program()
    t0 = time.perf_counter()
    out = finish(ell, config, prog, device, n_chips=1, peak=peak)
    _log_window(prog, t0)
    return out


# ---------------------------------------------------------------------------
# One process per card: the shard_map engine.
# ---------------------------------------------------------------------------

def _group_device(device: str, rank: int) -> torch.device:
    return torch.device("cuda", rank) if device.startswith("cuda") else torch.device("cpu")


def _init_group(rendezvous: str, rank: int, world: int, dev: torch.device) -> None:
    import torch.distributed as dist

    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=f"file://{rendezvous}", rank=rank,
                                world_size=world, device_id=dev)
    else:
        dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                                world_size=world)


def _save_partition(pg, path: str) -> None:
    fields = {f.name: np.asarray(getattr(pg, f.name)) for f in dataclasses.fields(pg)
              if getattr(pg, f.name) is not None}
    np.savez(path, **fields)


def _load_partition(path: str):
    from repro_torch.graph.partition import PartitionedGraph

    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    names = {f.name for f in dataclasses.fields(PartitionedGraph)}
    kw = {k: (v.item() if v.ndim == 0 else v) for k, v in arrays.items()}
    kw.update({k: None for k in names - set(kw)})
    return PartitionedGraph(**kw)


def _rank_main(rank, world, config, mix, seed, seconds, trace, device, paths,
               ready, results) -> None:
    """A spawned rank: waits for the partition, joins the group, runs the
    same window as rank 0 and sends back what rank 0 needs."""
    try:
        sys.path[:0] = [p for p in paths["sys_path"] if p not in sys.path]
        dev = _group_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if not ready.wait(GROUP_WAIT_S):
            raise TimeoutError("rank 0 did not partition the graph in time")
        pg = _load_partition(paths["partition"])
        _init_group(paths["rendezvous"], rank, world, dev)
        prog = session(pg, pg.n_global, config, mix, seed=seed, seconds=seconds,
                       trace=trace, device=dev, t_start=time.perf_counter(), rank=rank)
        torch.distributed.destroy_process_group()
        results.put((rank, "ok", {
            "peak_bytes": prog["peak_bytes"],
            "busy_s": prog["record"]["busy_s"] if trace else None,
            "forbidden": harness.forbidden_modules()}))
    except BaseException:
        traceback.print_exc()
        results.put((rank, "error", traceback.format_exc()))
        raise SystemExit(1) from None


def _watch(procs, stop: threading.Event) -> None:
    """End the run, with every rank, as soon as a spawned rank has failed:
    rank 0 may be waiting for it in a collective that never completes."""
    while not stop.wait(1.0):
        bad = [(i + 1, p.exitcode) for i, p in enumerate(procs)
               if p.exitcode not in (None, 0)]
        if bad:
            print(f"spawned ranks failed (rank, exit code): {bad}", file=sys.stderr,
                  flush=True)
            for p in procs:
                p.kill()
            os._exit(1)


def _run_group(config, mix, seed, seconds, trace, device, t_start) -> dict:
    """Rank 0 in this process, ranks 1.. spawned, one per card; the parent
    partitions once and hands the partition to the ranks through a file."""
    import torch.multiprocessing as mp

    from repro_torch.graph.partition import partition_graph

    world = config["n_parts"]
    if device.startswith("cuda"):
        from repro_torch.kernels.build import build
        build()                                 # once, before the ranks load
    tmp = tempfile.mkdtemp(prefix="bench-group-")
    paths = {"partition": os.path.join(tmp, "partition.npz"),
             "rendezvous": os.path.join(tmp, "rendezvous"),
             "sys_path": [p for p in sys.path if p]}
    ctx = mp.get_context("spawn")
    ready, results = ctx.Event(), ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, world, config, mix, seed, seconds,
                                                  trace, device, paths, ready, results))
             for r in range(1, world)]
    for p in procs:
        p.start()
    stop = threading.Event()
    threading.Thread(target=_watch, args=(procs, stop), daemon=True).start()
    try:
        t0 = time.perf_counter()
        dev = _group_device(device, 0)
        ell, graph = make_inputs(config, seed, dev)
        t1 = time.perf_counter()
        pg = partition_graph(graph, world, second_layer=config["second_layer"])
        partition_s = time.perf_counter() - t1
        log(f"graph {t1 - t0:.3f} s, partition {partition_s:.3f} s")
        del graph
        _save_partition(pg, paths["partition"])
        ready.set()
        _init_group(paths["rendezvous"], 0, world, dev)
        prog = session(pg, ell.shape[0], config, mix, seed=seed, seconds=seconds,
                       trace=trace, device=dev, t_start=t_start)
        prog["partition_s"] = partition_s
        torch.distributed.destroy_process_group()
        others = {}
        for _ in procs:
            try:
                rank, status, payload = results.get(timeout=GROUP_WAIT_S)
            except queue_mod.Empty:
                raise RuntimeError("a rank sent nothing back in time") from None
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            others[rank] = payload
        for p in procs:
            p.join(timeout=60)
    finally:
        stop.set()
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    found = sorted({m for o in others.values() for m in o["forbidden"]})
    if found:
        raise RuntimeError(f"a rank loaded {found}")
    peak = max([prog["peak_bytes"]] + [o["peak_bytes"] for o in others.values()])
    busy = None
    if trace:
        busy = float(np.mean([prog["record"]["busy_s"]]
                             + [o["busy_s"] for o in others.values()]))
    del pg
    _free_program()
    t0 = time.perf_counter()
    out = finish(ell, config, prog, dev, n_chips=world, peak=peak, busy_s=busy)
    _log_window(prog, t0)
    return out
