#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--graph hex:256,256,256] [--parts 8] [--seed 0]

Run from the root of a checkout.  It exits non-zero on any failure and
prints no result line when ``torch.cuda.is_available()`` is false.  In
order it:

1. prints the card's name and power limit (``nvidia-smi``) and builds
   every CUDA kernel of the port from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all at once);
2. holds each kernel to exact equality with its plain PyTorch version on
   the same CUDA tensors, on random inputs (the shapes of
   ``tests/test_kernels.py`` with 1 and 3 parts, both ``recolor_degrees``
   settings, one case without ghosts);
3. drives the main path: a cold ``color_distributed(..., backend="cuda")``
   on the graph, then three warm requests through one ``ColoringPlan``,
   each with a random 10% ``color_mask`` and ``colors0`` set to the
   previous coloring with the masked vertices cleared.  Every result must
   be a proper coloring and equal, field by field, to the ``reference``
   backend on the card.  The kernels' launch counts are zeroed just
   before this run and read just after it; each must be > 0.  They are
   also read around each request, and printed per request;
4. times each kernel and its plain version (CUDA events, median) on the
   inputs of the main path's first launch, holds them equal, computes
   each kernel's bound from the bytes these inputs need it to move, and
   prints one ``{"kernels": [...]}`` line;
5. prints ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet


def log(msg: str) -> None:
    print(msg, flush=True)


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def random_inputs(n, w, g, n_colors, seed, parts, device):
    """Stacked random kernel inputs on ``device``, as the card tests draw them."""
    import torch

    from repro_torch.kernels._testing import random_stacked

    _, stacked = random_stacked(n, w, g, n_colors, seed, parts)
    keys = ("adj", "tab", "base", "active", "deg", "gid", "bd")
    return {k: torch.from_numpy(a).to(device) for k, a in zip(keys, stacked)}


def check_equal(name, got, want) -> int:
    """Exact equality of tensor tuples; returns the max absolute difference."""
    import torch

    err = 0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain version by {err}")
    return err


def kernel_vs_plain_grid(device) -> int:
    from repro_torch.kernels._testing import SHAPES
    from repro_torch.kernels.conflict import conflict_detect, conflict_detect_ref
    from repro_torch.kernels.vb_bit import vb_bit_assign, vb_bit_assign_ref

    cases = 0
    for n, w, g in SHAPES + [(300, 5, 0)]:
        for parts in (1, 3):
            x = random_inputs(n, w, g, 60, n + parts, parts, device)
            args = (x["adj"], x["tab"][:, :n], x["base"], x["active"], x["tab"])
            check_equal(f"vb_bit {n, w, g, parts}", vb_bit_assign(*args),
                        vb_bit_assign_ref(*args))
            x = random_inputs(n, w, g, 6, n, parts, device)
            for rd in (True, False):
                args = (x["adj"], x["tab"][:, :n], x["deg"][:, :n], x["gid"][:, :n],
                        x["bd"], x["tab"], x["deg"], x["gid"], n)
                check_equal(f"conflict {n, w, g, parts, rd}",
                            conflict_detect(*args, recolor_degrees=rd),
                            conflict_detect_ref(*args, recolor_degrees=rd))
                cases += 1
            cases += 1
    return cases


def time_ms(fn, reps: int, batches: int = 3) -> float:
    """Time of one call: CUDA events around ``reps`` back-to-back calls,
    divided by ``reps``; the median of ``batches`` such runs, after two
    warm-up calls.  Queued back to back, the calls keep the device busy,
    so the host's launch cost hides behind the previous call."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def profile_request(label, request) -> None:
    """Where one request's time goes: host syncs, device busy share, top
    device activities.  Runs the request twice: once counting syncs, once
    under the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            request()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    log(f"[profile] {label} request: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms ({busy_us / wall_us:.1%}), idle "
        f"{1 - busy_us / wall_us:.1%}, host syncs {syncs}")
    for e in sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")


def distinct_entries(adj, lanes, n_tab) -> int:
    """Distinct table entries ``adj`` points at on the ``lanes`` mask,
    counted per part (a gather that reads each entry once moves this many)."""
    import torch

    p = adj.shape[0]
    idx = torch.where(lanes, adj, n_tab).to(torch.int64).view(p, -1)
    touched = torch.zeros((p, n_tab + 1), dtype=torch.bool, device=adj.device)
    touched.scatter_(1, idx, True)
    return int(touched[:, :n_tab].sum())


def vb_bit_bytes(adj, colors, active, tab) -> int:
    """Bytes ``vb_bit_assign`` must move on these inputs, each read once.

    Every row reads its base, active flag and color and writes its color
    and base; a row to color (active and uncolored) reads its adjacency and
    gathers its neighbors' colors.  ``colors`` is the table's owned
    segment, so the table counts once: every owned entry plus the other
    entries the gathers touch.
    """
    p, n, w = adj.shape
    todo = active & (colors == 0)
    table = p * n + distinct_entries(adj, todo[..., None] & (adj >= n), tab.shape[-1])
    return p * n * (4 + 1) + p * n * 8 + int(todo.sum()) * w * 4 + table * 4


def conflict_bytes(adj, colors, ctab, v_rows, n_loc, recolor_degrees) -> int:
    """Bytes ``conflict_detect`` must move on these inputs, each read once.

    Every lane reads its adjacency entry and writes its ``lose_o`` byte,
    every row writes ``lose_v``, every part its count.  A row reads its
    color only if it has a ghost lane, gathers a ghost's color only if its
    own color is set, reads its own and the ghost's gid (and degree, with
    ``recolor_degrees``) only where the colors collide, and reads
    ``is_boundary`` only on ``v_rows``, the rows that lose on some lane.
    """
    from repro_torch.core.local import gather_rows

    p, n, w = adj.shape
    n_tab = ctab.shape[-1] - 1
    ghost = (adj >= n_loc) & (adj < n_tab)
    colored = ghost & (colors[..., None] > 0)
    collide = colored & (gather_rows(ctab, adj) == colors[..., None])
    words = 2 if recolor_degrees else 1         # gid, and degree
    return (p * n * w * (4 + 1) + p * n + p * 4
            + int(ghost.any(-1).sum()) * 4
            + distinct_entries(adj, colored, n_tab) * 4
            + distinct_entries(adj, collide, n_tab) * 4 * words
            + int(collide.any(-1).sum()) * 4 * words
            + int(v_rows.sum()))


def same_result(a, b) -> bool:
    return (np.array_equal(a.colors, b.colors) and a.rounds == b.rounds
            and a.converged == b.converged
            and a.total_conflicts == b.total_conflicts
            and a.n_colors == b.n_colors
            and np.array_equal(a.comm_bytes_by_round, b.comm_bytes_by_round)
            and np.array_equal(a.comm_bytes_by_level, b.comm_bytes_by_level))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph", default="hex:256,256,256")
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20, help="timed calls per kernel")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run",
              file=sys.stderr)
        return 1
    return run(torch.device("cuda", 0), args)


def run(device, args) -> int:
    """All phases on ``device``; raises on the first failure."""
    import torch

    from repro_torch.core.backend import CudaBackend
    from repro_torch.core.distributed import (
        _recolor_part, _table, color_distributed,
    )
    from repro_torch.core.plan import ColoringPlan
    from repro_torch.core.validate import is_proper_d1
    from repro_torch.graph.partition import partition_graph
    from repro_torch.kernels import build
    from repro_torch.kernels.conflict import conflict_detect, conflict_detect_ref
    from repro_torch.kernels.vb_bit import vb_bit_assign, vb_bit_assign_ref
    from repro_torch.launch.color import make_graph

    ident = card_identity()
    log(f"[card] {ident}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    build.build()
    log(f"[build] {len(build.SOURCES)} kernels in {time.perf_counter() - t0:.1f} s")
    for name in build.SOURCES:
        for line in build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # -- 2. kernel vs plain on random inputs ---------------------------------
    cases = kernel_vs_plain_grid(device)
    torch.cuda.synchronize()
    log(f"[kernels] {cases} random cases: both kernels equal their plain versions")

    # -- 3. main path --------------------------------------------------------
    t0 = time.perf_counter()
    g = make_graph(args.graph)
    t1 = time.perf_counter()
    pg = partition_graph(g, args.parts)
    t2 = time.perf_counter()
    log(f"[graph] {g.name}: n={g.n} m={g.num_edges} maxdeg={g.max_degree} "
        f"generate {t1 - t0:.1f} s, partition into {args.parts} parts "
        f"{t2 - t1:.1f} s (n_local={pg.n_local} ghosts={pg.n_ghost} "
        f"send={pg.send_width} W={pg.ell_width})")

    rng = np.random.default_rng(args.seed)
    masks = [rng.random(g.n) < 0.1 for _ in range(3)]
    kernels = (vb_bit_assign, conflict_detect)
    counts = [(k.__name__, k) for k in kernels]
    per_request = []        # launches of each request, read around it

    def timed(label, request):
        before = {name: k.launches for name, k in counts}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = request()
        torch.cuda.synchronize()
        per_request.append((label, {name: k.launches - before[name]
                                    for name, k in counts}))
        return out, time.perf_counter() - t0

    for k in kernels:
        k.launches = 0
    cold, cold_s = timed("cold color_distributed",
                         lambda: color_distributed(pg, backend="cuda", device=device))
    t0 = time.perf_counter()
    plan = ColoringPlan(pg, backend="cuda", device=device)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    # The plan's own first request is cold too; it must repeat the entry
    # point's result exactly (the runtime is deterministic).
    again, _ = timed("cold plan.run", plan.run)
    if not same_result(again, cold):
        raise AssertionError("a second cold request differs from the first")
    results, warm_s, colors0 = [cold], [], []
    for i, m in enumerate(masks):
        c0 = results[-1].colors.copy()
        c0[m] = 0
        colors0.append(c0)
        r, s = timed(f"warm {i + 1}", lambda: plan.run(color_mask=m, colors0=c0))
        results.append(r)
        warm_s.append(s)
    launches = {name: k.launches for name, k in counts}
    log(f"[main] cold color_distributed {cold_s:.3f} s (rounds={cold.rounds} "
        f"conflicts={cold.total_conflicts} colors={cold.n_colors}); plan upload "
        f"{plan_s:.3f} s; warm requests {[round(s, 4) for s in warm_s]} s "
        f"(rounds={[r.rounds for r in results[1:]]})")
    for label, n in per_request:
        log(f"[main] launches in {label}: {n}")
    log(f"[main] launches on the main path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    for i, r in enumerate(results):
        if not (r.converged and is_proper_d1(g, r.colors)):
            raise AssertionError(f"request {i}: coloring is not proper")
    ref_plan = ColoringPlan(pg, backend="reference", device=device)
    t0 = time.perf_counter()
    refs = [ref_plan.run()]
    refs += [ref_plan.run(color_mask=m, colors0=c0) for m, c0 in zip(masks, colors0)]
    torch.cuda.synchronize()
    log(f"[main] reference backend on the card: 4 requests in "
        f"{time.perf_counter() - t0:.3f} s")
    for i, (r, ref) in enumerate(zip(results, refs)):
        if not same_result(r, ref):
            raise AssertionError(f"request {i}: cuda backend differs from reference")
    log("[main] 4 requests proper and equal to the reference backend in colors, "
        "rounds, converged, total_conflicts, n_colors and comm bytes")
    profile_request("cold", plan.run)
    profile_request("warm", lambda: plan.run(color_mask=masks[0], colors0=colors0[0]))

    # -- 4. kernel timings at the main path's shapes --------------------------
    st = plan._st
    n = plan.n_local
    c0, g0, a0, _ = plan.request_inputs()
    c0 = torch.from_numpy(c0).to(device)
    g0 = torch.from_numpy(g0).to(device)
    a0 = torch.from_numpy(a0).to(device)
    # vb_bit: the first launch of the cold run (every active row uncolored).
    tab = _table(c0, g0)
    base = torch.ones_like(c0)
    vb_args = (st["adj_cidx"], tab[:, :n], base, a0, tab)
    # conflict: the first detect of the cold run, after the initial
    # coloring and the first exchange.
    colors = _recolor_part(st, c0, g0, a0, torch.zeros_like(g0, dtype=torch.bool),
                           problem="d1", recolor_degrees=True, backend=CudaBackend())
    ghost, _, _ = plan._strategy.stacked(st, colors, ())
    ctab = _table(colors, ghost)
    cf_args = (st["adj_cidx"], colors, st["deg_tab"][:, :n], st["gid_tab"][:, :n],
               st["is_boundary"], ctab, st["deg_tab"], st["gid_tab"], n)

    vb_bytes = vb_bit_bytes(st["adj_cidx"], tab[:, :n], a0, tab)
    # The rows that lose on some lane: lose_v before the boundary mask.
    v_rows, _, _ = conflict_detect_ref(*cf_args[:4], torch.ones_like(st["is_boundary"]),
                                       *cf_args[5:], recolor_degrees=True)
    cf_bytes = conflict_bytes(st["adj_cidx"], colors, ctab, v_rows, n, True)

    entries = []
    for name, kern, plain, kargs, kw, nbytes, src, replaces in (
        ("vb_bit_assign", vb_bit_assign, vb_bit_assign_ref, vb_args, {}, vb_bytes,
         "src/repro_torch/csrc/vb_bit.cu", "src/repro/kernels/vb_bit.py:84"),
        ("conflict_detect", conflict_detect, conflict_detect_ref, cf_args,
         {"recolor_degrees": True}, cf_bytes,
         "src/repro_torch/csrc/conflict.cu", "src/repro/kernels/conflict.py:107"),
    ):
        err = check_equal(f"{name} main-path inputs", kern(*kargs, **kw),
                          plain(*kargs, **kw))
        ms = time_ms(lambda: kern(*kargs, **kw), args.reps)
        plain_ms = time_ms(lambda: plain(*kargs, **kw), max(args.reps // 4, 3))
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"[time] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({nbytes} B over 3.35 TB/s), "
            f"{bound_ms / ms:.1%} of the bound")
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None,
        })
    torch.cuda.synchronize()

    log(json.dumps({"kernels": entries}))
    log(card_identity())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
