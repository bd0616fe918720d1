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
   and ``partial_d2`` settings, cases without ghosts and with one ghost
   slot that holds no real ghost, ragged row counts; ``pair_scatter`` on
   batches of 1 to 64 rows with padding, up to ``S`` pairs and none real;
   ``fused_round`` with ``(slot, color)`` pairs for d1 and d2);
3. generates the graph once and drives every path of the port on it, each
   with the kernels' launch counts set to 0 just before it and read just
   after it (and around each request), each kernel > 0 on the paths that
   use it; every result must be proper for its problem and equal, field
   by field, to the ``reference`` backend on the card:

   - d1 ``cuda``: a cold ``color_distributed``, then three warm requests
     through one ``ColoringPlan``, each with a random 10% ``color_mask``
     and ``colors0`` set to the previous coloring with the masked
     vertices cleared; a cold and a warm request profiled;
   - d1 ``cuda_fused``: the same four requests; a warm one profiled;
   - the ghost exchanges on ``cuda_fused``: ``halo``, ``delta``,
     ``sparse_delta(scatter="cuda")`` and ``hier_delta(scatter="cuda")``,
     the same four requests on one plan each, each equal to ``all_gather``
     (the ``cuda_fused`` requests above) in colors, rounds, conflicts and
     colors used, and the sparse two equal in every field (comm bytes by
     round and by level included) to the same exchange with the plain
     ``scatter="reference"``; their bytes printed; a warm
     ``sparse_delta`` request profiled;
   - on the same graph partitioned with a second ghost layer, ``d2`` and
     ``pd2`` on ``cuda`` and ``cuda_fused``, a cold and a warm 10% request
     each (a ``cuda_fused`` d2 warm request profiled), d2 on ``cuda_fused``
     with ``sparse_delta`` and ``hier_delta`` (``scatter="cuda"``), cold
     and warm, equal to ``all_gather``, and ``d1_2gl`` cold on both
     backends; the peak device memory after each problem;
4. times each kernel and its plain version (CUDA events, median) on the
   inputs of its first main-path launch, right after the path that makes
   them (``fused_round`` on d1's, with and without pairs, and, for
   ``PERF.md``, on d2's; ``pair_scatter`` on the first ``sparse_delta``
   round's, beside the one PyTorch call that computes the same function,
   ``torch.scatter``), holds them equal, computes each kernel's bound
   from the bytes these inputs need it to move, and prints one
   ``{"kernels": [...]}`` line with each kernel's launches summed over the
   paths;
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
VALIDATORS = {"d1": "is_proper_d1", "d1_2gl": "is_proper_d1",
              "d2": "is_proper_d2", "pd2": "is_proper_pd2"}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def wrappers() -> dict:
    """Every kernel wrapper of the port, by name; each counts its launches."""
    from repro_torch.kernels.conflict import conflict_detect
    from repro_torch.kernels.d2_forbidden import d2_assign
    from repro_torch.kernels.fused_round import fused_round
    from repro_torch.kernels.scatter import pair_scatter
    from repro_torch.kernels.vb_bit import vb_bit_assign

    return {k.__name__: k for k in (vb_bit_assign, conflict_detect, d2_assign,
                                    fused_round, pair_scatter)}


def to_device(arrays, device):
    import torch

    return [torch.from_numpy(a).to(device) for a in arrays]


def random_inputs(n, w, g, n_colors, seed, parts, device):
    """Stacked random kernel inputs on ``device``, as the card tests draw them."""
    from repro_torch.kernels._testing import random_stacked

    _, stacked = random_stacked(n, w, g, n_colors, seed, parts)
    keys = ("adj", "tab", "base", "active", "deg", "gid", "bd")
    return dict(zip(keys, to_device(stacked, device)))


def check_equal(name, got, want) -> int:
    """Exact equality of tensor tuples; returns the max absolute difference."""
    import torch

    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = 0
    for a, b in zip(got, want, strict=True):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain version by {err}")
    return err


def kernel_vs_plain_grid(device) -> dict[str, int]:
    """Random cases of every kernel against its plain version; case counts."""
    from repro_torch.kernels._testing import (
        D2_SHAPES, ROUND_SHAPES, SCATTER_SHAPES, SHAPES, random_ext, random_pairs,
        random_round, round_pairs,
    )
    from repro_torch.kernels.conflict import conflict_detect, conflict_detect_ref
    from repro_torch.kernels.d2_forbidden import d2_assign, d2_assign_ref
    from repro_torch.kernels.fused_round import fused_round, fused_round_ref
    from repro_torch.kernels.scatter import pair_scatter, pair_scatter_ref
    from repro_torch.kernels.vb_bit import vb_bit_assign, vb_bit_assign_ref

    cases = dict.fromkeys(wrappers(), 0)
    for n, w, g in SHAPES + [(300, 5, 0)]:
        for parts in (1, 3):
            x = random_inputs(n, w, g, 60, n + parts, parts, device)
            args = (x["adj"], x["tab"][:, :n], x["base"], x["active"], x["tab"])
            check_equal(f"vb_bit {n, w, g, parts}", vb_bit_assign(*args),
                        vb_bit_assign_ref(*args))
            cases["vb_bit_assign"] += 1
            x = random_inputs(n, w, g, 6, n, parts, device)
            for rd in (True, False):
                args = (x["adj"], x["tab"][:, :n], x["deg"][:, :n], x["gid"][:, :n],
                        x["bd"], x["tab"], x["deg"], x["gid"], n)
                check_equal(f"conflict {n, w, g, parts, rd}",
                            conflict_detect(*args, recolor_degrees=rd),
                            conflict_detect_ref(*args, recolor_degrees=rd))
                cases["conflict_detect"] += 1
    for n, w, g in D2_SHAPES + [(515, 6, 200)]:
        for parts in (1, 3):
            x = random_inputs(n, w, g, 20, n * 7, parts, device)
            ext, = to_device([random_ext(n, w, g, n, parts)], device)
            for partial_d2 in (False, True):
                args = (x["adj"], ext, x["tab"], x["base"], x["active"])
                check_equal(f"d2_assign {n, w, g, parts, partial_d2}",
                            d2_assign(*args, partial_d2=partial_d2),
                            d2_assign_ref(*args, partial_d2=partial_d2))
                cases["d2_assign"] += 1
    for n, w, g, real in ROUND_SHAPES:
        for parts in (1, 3):
            adj, th, colors, ghost, deg, gid, bd = to_device(
                random_round(n, w, g, n + parts, parts, real_ghosts=real), device)
            for problem in ("d1", "d2", "pd2"):
                for rd in (True, False):
                    args = (adj, colors, ghost, deg, gid, bd,
                            None if problem == "d1" else th)
                    kw = dict(problem=problem, recolor_degrees=rd)
                    check_equal(f"fused_round {n, w, g, real, parts, problem, rd}",
                                fused_round(*args, **kw), fused_round_ref(*args, **kw))
                    cases["fused_round"] += 1
            pairs = to_device(round_pairs(g, n + 11, parts), device)
            for problem in ("d1", "d2"):
                args = (adj, colors, ghost, deg, gid, bd,
                        None if problem == "d1" else th, *pairs)
                check_equal(f"fused_round pairs {n, w, g, real, parts, problem}",
                            fused_round(*args, problem=problem),
                            fused_round_ref(*args, problem=problem))
                cases["fused_round"] += 1
    for rows, s, c, k in SCATTER_SHAPES:
        args = to_device(random_pairs(rows, s, c, rows + s + c, k=k), device)
        check_equal(f"pair_scatter {rows, s, c, k}", pair_scatter(*args),
                    pair_scatter_ref(*args))
        cases["pair_scatter"] += 1
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


def touched_entries(blocks, n_tab) -> int:
    """Distinct table entries that the ``(index block, lane mask)`` pairs
    point at, counted per part and summed (a gather that reads each entry
    once moves this many).  Parts are marked one at a time, so the int64
    indices of one part's block are the largest temporary."""
    import torch

    p = blocks[0][0].shape[0]
    total = 0
    for q in range(p):
        seen = torch.zeros(n_tab + 1, dtype=torch.bool, device=blocks[0][0].device)
        for idx, lanes in blocks:
            seen[torch.where(lanes[q], idx[q], n_tab).to(torch.int64).view(-1)] = True
        total += int(seen[:n_tab].sum())
    return total


def distinct_entries(adj, lanes, n_tab) -> int:
    """Distinct table entries ``adj`` points at on the ``lanes`` mask."""
    return touched_entries([(adj, lanes)], n_tab)


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


def d2_assign_bytes(adj, two_hop, colors, active, tab, partial_d2) -> int:
    """Bytes ``d2_assign`` must move on these inputs, each read once.

    As :func:`vb_bit_bytes`, and a row to color also reads the extended
    adjacency row of each neighbor (each such row counted once per part);
    the table entries it gathers are the two-hop ones, and the one-hop ones
    unless ``partial_d2``.
    """
    p, n, w = adj.shape
    n_tab = tab.shape[-1]
    todo = active & (colors == 0)
    blocks = [(two_hop, todo[..., None] & (two_hop >= n))]
    if not partial_d2:
        blocks.append((adj, todo[..., None] & (adj >= n)))
    table = p * n + touched_entries(blocks, n_tab)
    ext_rows = distinct_entries(adj, todo[..., None].expand_as(adj), n_tab)
    return (p * n * (4 + 1) + p * n * 8 + int(todo.sum()) * w * 4
            + ext_rows * w * 4 + table * 4)


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


def fused_round_bytes(st, colors, ghost, problem, recolor_degrees,
                      pairs=None) -> tuple[int, int]:
    """Bytes ``fused_round`` must move on these inputs, each read once, and
    the fixed-point iterations the plain version takes on them.

    With ``pairs`` (slots, colors), each real pair is read once and the
    round is counted on the ghosts the pairs make.

    The detection sweep once, as :func:`conflict_bytes` counts it over each
    block it sweeps, without the per-lane output: every row's color, every
    lane's index, ghost colors on colored rows' ghost lanes, gids and
    degrees where colors collide, ``is_boundary`` on rows that lose, and
    the outputs (colors, ``lose_v``, ``lose_ghost``, counts).  Then, in
    each fixed-point iteration, the lanes of the active rows of running
    parts and the table entries they name.
    """
    import torch

    from repro_torch.core.backend import ReferenceBackend
    from repro_torch.core.distributed import _detect_part, _table
    from repro_torch.core.local import (
        MAX_ITERS_D1, MAX_ITERS_D2, _speculate_round, gather_rows, iterate_parts,
    )
    from repro_torch.kernels.scatter import pair_scatter_ref

    pair_bytes = 0
    if pairs is not None:
        ghost = pair_scatter_ref(ghost, *pairs)
        pair_bytes = int(((pairs[0] >= 0) & (pairs[0] < ghost.shape[-1])).sum()) * 8
    two_hop = st["two_hop_cidx"] if problem != "d1" else None
    blocks = ([st["adj_cidx"]] if problem != "pd2" else []) + (
        [two_hop] if two_hop is not None else [])
    p, n = colors.shape
    g = ghost.shape[-1]
    n_tab = n + g + 1
    ctab = _table(colors, ghost)
    words = 2 if recolor_degrees else 1
    nbytes = p * n * 4 + p * n + p * g + p * 4 + p * n * 4
    colored_lanes, collide_lanes = [], []
    own_collide = torch.zeros_like(colors, dtype=torch.bool)
    v_rows = torch.zeros_like(own_collide)
    ones = torch.ones_like(own_collide)
    for blk in blocks:
        nbytes += blk.numel() * 4
        is_ghost = (blk >= n) & (blk < n + g)
        colored = is_ghost & (colors[..., None] > 0)
        collide = colored & (gather_rows(ctab, blk) == colors[..., None])
        colored_lanes.append((blk, colored))
        collide_lanes.append((blk, collide))
        own_collide |= collide.any(-1)
        v_rows |= ReferenceBackend().detect(
            blk, colors, ctab, st["deg_tab"], st["gid_tab"], ones,
            recolor_degrees=recolor_degrees)[0]
    nbytes += (touched_entries(colored_lanes, n_tab) * 4
               + touched_entries(collide_lanes, n_tab) * 4 * words
               + int(own_collide.sum()) * 4 * words + int(v_rows.sum()))

    lose, _, _ = _detect_part(st, colors, ghost, problem=problem,
                              recolor_degrees=recolor_degrees)
    per_iter = []

    def step(tab, base):
        # iterate_parts tests running parts on this very table.
        rows = lose & (lose & (tab[:, :n] == 0)).any(dim=1)[:, None]
        per_iter.append(sum(int(rows.sum()) * blk.shape[-1] * 4 for blk in blocks)
                        + touched_entries([(blk, rows[..., None].expand_as(blk))
                                           for blk in blocks], n_tab) * 4)
        return _speculate_round(tab, base, st["adj_cidx"], lose, st["deg_tab"],
                                st["gid_tab"], two_hop, problem == "pd2",
                                recolor_degrees)

    iterate_parts(step, _table(torch.where(lose, 0, colors), ghost), lose,
                  max_iters=MAX_ITERS_D1 if problem == "d1" else MAX_ITERS_D2)
    return nbytes + pair_bytes + sum(per_iter), len(per_iter)


def pair_scatter_bytes(table, slots) -> int:
    """Bytes ``pair_scatter`` must move on these inputs: the table read and
    written once, and each real pair (slot and value) read once."""
    real = (slots >= 0) & (slots < table.shape[-1])
    return table.numel() * 4 * 2 + int(real.sum()) * 8


def same_result(a, b) -> bool:
    return (np.array_equal(a.colors, b.colors) and a.rounds == b.rounds
            and a.converged == b.converged
            and a.total_conflicts == b.total_conflicts
            and a.n_colors == b.n_colors
            and np.array_equal(a.comm_bytes_by_round, b.comm_bytes_by_round)
            and np.array_equal(a.comm_bytes_by_level, b.comm_bytes_by_level))


class Launches:
    """Launch counts of the kernel wrappers, read around each request and
    over each path; a path's counts are zeroed just before it."""

    def __init__(self):
        self.kernels = wrappers()
        self.paths: dict[str, dict[str, int]] = {}

    def read(self) -> dict[str, int]:
        return {name: k.launches for name, k in self.kernels.items()}

    def start(self) -> None:
        for k in self.kernels.values():
            k.launches = 0

    def timed(self, label, request):
        """Run one request to its end on the card; returns (result, seconds)
        and logs its launches."""
        import torch

        before = self.read()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = request()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n = {k: v - before[k] for k, v in self.read().items() if v != before[k]}
        log(f"[main] {label}: {seconds:.4f} s, rounds={out.rounds} "
            f"conflicts={out.total_conflicts} colors={out.n_colors}, launches {n}")
        return out, seconds

    def end(self, path: str, uses) -> None:
        counts = self.read()
        self.paths[path] = counts
        log(f"[main] launches on the {path} path: {counts}")
        for name in uses:
            if counts[name] <= 0:
                raise AssertionError(f"{name} was not launched on the {path} path")

    def total(self, name: str) -> int:
        return sum(c[name] for c in self.paths.values())


def check_results(label, g, problem, results, refs) -> None:
    """Every result proper for its problem and equal to the reference's."""
    from repro_torch.core import validate

    proper = getattr(validate, VALIDATORS[problem])
    for i, (r, ref) in enumerate(zip(results, refs, strict=True)):
        if not (r.converged and proper(g, r.colors)):
            raise AssertionError(f"{label} request {i}: coloring is not proper")
        if not same_result(r, ref):
            raise AssertionError(f"{label} request {i}: differs from the reference backend")
    log(f"[main] {label}: {len(results)} requests proper ({VALIDATORS[problem]}) and "
        "equal to the reference backend in colors, rounds, converged, "
        "total_conflicts, n_colors and comm bytes by round and by level")


def time_kernel(label, kern, plain, kargs, kw, nbytes, reps) -> dict:
    """Hold a kernel equal to its plain version on main-path inputs, time
    both, log them against the bytes bound, and return the measured keys of
    its ``{"kernels": [...]}`` entry."""
    err = check_equal(f"{label} main-path inputs", kern(*kargs, **kw), plain(*kargs, **kw))
    ms = time_ms(lambda: kern(*kargs, **kw), reps)
    plain_ms = time_ms(lambda: plain(*kargs, **kw), max(reps // 4, 3))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[time] {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({nbytes} B over 3.35 TB/s), "
        f"{bound_ms / ms:.1%} of the bound")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms}


def kernel_entry(name, src, replaces, measured) -> dict:
    """One kernel's ``{"kernels": [...]}`` entry; its ``launches`` are filled
    in once every path has run."""
    return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": None, **measured, "bound_by": "bytes", "library_ms": None}


def first_round_inputs(plan, problem, device):
    """The inputs of a cold request's first round: the initial coloring on
    the ``cuda`` backend, then the first exchange.  Returns (colors, ghost)."""
    import torch

    from repro_torch.core.backend import CudaBackend
    from repro_torch.core.distributed import _recolor_part

    c0, g0, a0, _ = plan.request_inputs()
    c0, g0, a0 = to_device((c0, g0, a0), device)
    colors = _recolor_part(plan._st, c0, g0, a0, torch.zeros_like(g0, dtype=torch.bool),
                           problem=problem, recolor_degrees=True, backend=CudaBackend())
    ghost, _, _ = plan._strategy.stacked(plan._st, colors,
                                         plan._strategy.init_state(plan._st))
    return colors, ghost


def first_pairs(plan, colors, ghost):
    """The ``pair_scatter`` inputs of a ``sparse_delta`` plan's first
    exchange after the initial coloring ``colors``: the receiver-major
    ``(P, P, S)`` slot tables and the pairs packed for them, as
    ``SparseDeltaExchange.stacked`` makes them.  Checks that the pairs
    deliver ``ghost``, the ghosts of that exchange."""
    import torch

    from repro_torch.core.exchange import _gather_ghosts, pack_pairs, send_buffer
    from repro_torch.kernels.scatter import pair_scatter_ref

    st = plan._st
    state = plan._strategy.init_state(st)
    send = send_buffer(colors, st)
    changed = st["send_mask"] & (send != state["prev_send"])
    slots, cols, _ = pack_pairs(changed[:, None, :] & st["peer_need"], send[:, None, :])
    args = (state["ghost_tab"], slots.transpose(0, 1).contiguous(),
            cols.transpose(0, 1).contiguous())
    if not torch.equal(_gather_ghosts(pair_scatter_ref(*args), st), ghost):
        raise AssertionError("the first sparse_delta pairs do not deliver its ghosts")
    return args


def check_exchange(label, g, problem, results, ag_results) -> None:
    """Every result proper and equal to ``all_gather``'s in colors, rounds,
    conflicts and colors used (its bytes are its own)."""
    from repro_torch.core import validate

    proper = getattr(validate, VALIDATORS[problem])
    for i, (r, ag) in enumerate(zip(results, ag_results, strict=True)):
        if not (r.converged and proper(g, r.colors)):
            raise AssertionError(f"{label} request {i}: coloring is not proper")
        if not (np.array_equal(r.colors, ag.colors) and r.rounds == ag.rounds
                and r.total_conflicts == ag.total_conflicts
                and r.n_colors == ag.n_colors):
            raise AssertionError(f"{label} request {i}: differs from all_gather")
    log(f"[main] {label}: {len(results)} requests proper ({VALIDATORS[problem]}) and "
        "equal to all_gather in colors, rounds, conflicts and colors used; comm bytes "
        f"total {[r.comm_bytes_total for r in results]}, [intra, inter] "
        f"{[[r.comm_bytes_intra, r.comm_bytes_inter] for r in results]}, by round "
        f"{[[int(b) for b in r.comm_bytes_by_round] for r in results]}")


def make_exchange(name, scatter=None):
    """A fresh exchange strategy; the sparse ones with ``scatter``."""
    from repro_torch.core.exchange import EXCHANGES

    return EXCHANGES[name](scatter=scatter) if scatter else EXCHANGES[name]()


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

    from repro_torch.core.distributed import _table, color_distributed
    from repro_torch.core.plan import ColoringPlan
    from repro_torch.graph.partition import partition_graph
    from repro_torch.kernels import build
    from repro_torch.kernels.conflict import conflict_detect, conflict_detect_ref
    from repro_torch.kernels.d2_forbidden import d2_assign, d2_assign_ref
    from repro_torch.kernels.fused_round import fused_round, fused_round_ref
    from repro_torch.kernels.scatter import pair_scatter, pair_scatter_ref
    from repro_torch.kernels.vb_bit import vb_bit_assign, vb_bit_assign_ref
    from repro_torch.launch.color import make_graph

    t_start = time.perf_counter()
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
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # -- 2. kernel vs plain on random inputs ---------------------------------
    cases = kernel_vs_plain_grid(device)
    torch.cuda.synchronize()
    log(f"[kernels] random cases {cases}: every kernel equals its plain version")

    # -- 3. the paths ------------------------------------------------------------
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
    ledger = Launches()

    # d1, cuda: cold color_distributed, then three warm requests in one plan.
    ledger.start()
    cold, cold_s = ledger.timed("d1 cuda cold color_distributed",
                                lambda: color_distributed(pg, backend="cuda", device=device))
    t0 = time.perf_counter()
    plan = ColoringPlan(pg, backend="cuda", device=device)
    torch.cuda.synchronize()
    log(f"[main] d1 plan upload {time.perf_counter() - t0:.3f} s")
    # The plan's own first request is cold too; it must repeat the entry
    # point's result exactly (the runtime is deterministic).
    again, _ = ledger.timed("d1 cuda cold plan.run", plan.run)
    if not same_result(again, cold):
        raise AssertionError("a second cold request differs from the first")
    results, colors0 = [cold], []
    for i, m in enumerate(masks):
        c0 = results[-1].colors.copy()
        c0[m] = 0
        colors0.append(c0)
        r, _ = ledger.timed(f"d1 cuda warm {i + 1}",
                            lambda: plan.run(color_mask=m, colors0=c0))
        results.append(r)
    ledger.end("d1 cuda", ("vb_bit_assign", "conflict_detect"))

    ref_plan = ColoringPlan(pg, backend="reference", device=device)
    t0 = time.perf_counter()
    refs = [ref_plan.run()]
    refs += [ref_plan.run(color_mask=m, colors0=c0) for m, c0 in zip(masks, colors0)]
    torch.cuda.synchronize()
    log(f"[main] d1 reference backend on the card: 4 requests in "
        f"{time.perf_counter() - t0:.3f} s")
    del ref_plan
    check_results("d1 cuda", g, "d1", results, refs)
    profile_request("d1 cuda cold", plan.run)
    profile_request("d1 cuda warm",
                    lambda: plan.run(color_mask=masks[0], colors0=colors0[0]))

    # Kernel timings at the d1 shapes: the inputs of the first launches of
    # the cold run (vb_bit: every active row uncolored; conflict and
    # fused_round: the first round, after the initial coloring and the
    # first exchange).
    st, n = plan._st, plan.n_local
    c0, g0, a0, _ = plan.request_inputs()
    c0, g0, a0 = to_device((c0, g0, a0), device)
    tab = _table(c0, g0)
    vb_args = (st["adj_cidx"], tab[:, :n], torch.ones_like(c0), a0, tab)
    colors, ghost = first_round_inputs(plan, "d1", device)
    ctab = _table(colors, ghost)
    cf_args = (st["adj_cidx"], colors, st["deg_tab"][:, :n], st["gid_tab"][:, :n],
               st["is_boundary"], ctab, st["deg_tab"], st["gid_tab"], n)
    # The rows that lose on some lane: lose_v before the boundary mask.
    v_rows, _, _ = conflict_detect_ref(*cf_args[:4], torch.ones_like(st["is_boundary"]),
                                       *cf_args[5:], recolor_degrees=True)
    entries = {
        "vb_bit_assign": kernel_entry(
            "vb_bit_assign", "src/repro_torch/csrc/vb_bit.cu",
            "src/repro/kernels/vb_bit.py:84",
            time_kernel("vb_bit_assign", vb_bit_assign, vb_bit_assign_ref, vb_args, {},
                        vb_bit_bytes(st["adj_cidx"], tab[:, :n], a0, tab), args.reps)),
        "conflict_detect": kernel_entry(
            "conflict_detect", "src/repro_torch/csrc/conflict.cu",
            "src/repro/kernels/conflict.py:107",
            time_kernel("conflict_detect", conflict_detect, conflict_detect_ref, cf_args,
                        {"recolor_degrees": True},
                        conflict_bytes(st["adj_cidx"], colors, ctab, v_rows, n, True),
                        args.reps)),
    }
    fr_bytes, fr_iters = fused_round_bytes(st, colors, ghost, "d1", True)
    log(f"[time] fused_round d1 first-round inputs: the plain fixed point "
        f"takes {fr_iters} iterations")
    entries["fused_round"] = kernel_entry(
        "fused_round", "src/repro_torch/csrc/fused_round.cu",
        "src/repro/kernels/fused_round.py:298",
        time_kernel("fused_round", fused_round, fused_round_ref,
                    (st["adj_cidx"], colors, ghost, st["deg_tab"], st["gid_tab"],
                     st["is_boundary"]), {"problem": "d1"}, fr_bytes, args.reps))
    # fused_round with pairs on the same inputs: the ghosts start at 0 and
    # every real ghost's color arrives as a (slot, color) pair, which must
    # give the same round.
    n_ghost = ghost.shape[-1]
    pslots = torch.where(st["ghost_real"],
                         torch.arange(n_ghost, dtype=torch.int32, device=device), n_ghost)
    pair_args = (st["adj_cidx"], colors, torch.zeros_like(ghost), st["deg_tab"],
                 st["gid_tab"], st["is_boundary"], None, pslots, ghost)
    check_equal("fused_round with pairs against without", fused_round(*pair_args),
                fused_round(st["adj_cidx"], colors, ghost, st["deg_tab"], st["gid_tab"],
                            st["is_boundary"]))
    fp_bytes, _ = fused_round_bytes(st, colors, torch.zeros_like(ghost), "d1", True,
                                    pairs=(pslots, ghost))
    time_kernel("fused_round with pairs", fused_round, fused_round_ref, pair_args,
                {"problem": "d1"}, fp_bytes, args.reps)
    del plan, st, vb_args, cf_args, tab, ctab, colors, ghost, pair_args, pslots

    # d1, cuda_fused: the same four requests.
    ledger.start()
    fused, _ = ledger.timed("d1 cuda_fused cold color_distributed",
                            lambda: color_distributed(pg, backend="cuda_fused",
                                                      device=device))
    fplan = ColoringPlan(pg, backend="cuda_fused", device=device)
    fused = [fused]
    for i, (m, c0) in enumerate(zip(masks, colors0)):
        fused.append(ledger.timed(f"d1 cuda_fused warm {i + 1}",
                                  lambda: fplan.run(color_mask=m, colors0=c0))[0])
    ledger.end("d1 cuda_fused", ("vb_bit_assign", "fused_round"))
    check_results("d1 cuda_fused", g, "d1", fused, refs)
    profile_request("d1 cuda_fused warm",
                    lambda: fplan.run(color_mask=masks[0], colors0=colors0[0]))
    del fplan

    # The ghost exchanges on cuda_fused, one plan each, the same requests.
    for name in ("halo", "delta", "sparse_delta", "hier_delta"):
        scatter = "cuda" if name in ("sparse_delta", "hier_delta") else None
        ledger.start()
        t0 = time.perf_counter()
        xplan = ColoringPlan(pg, backend="cuda_fused", exchange=make_exchange(name, scatter),
                             device=device)
        torch.cuda.synchronize()
        log(f"[main] d1 {name} plan upload (route plan included) "
            f"{time.perf_counter() - t0:.3f} s")
        got = [ledger.timed(f"d1 {name} cold", xplan.run)[0]]
        for i, (m, c0) in enumerate(zip(masks, colors0)):
            got.append(ledger.timed(f"d1 {name} warm {i + 1}",
                                    lambda: xplan.run(color_mask=m, colors0=c0))[0])
        ledger.end(f"d1 {name}", ("vb_bit_assign", "fused_round")
                   + (("pair_scatter",) if scatter else ()))
        check_exchange(f"d1 {name}", g, "d1", got, fused)
        if scatter:
            rplan = ColoringPlan(pg, backend="cuda_fused",
                                 exchange=make_exchange(name, "reference"), device=device)
            plain = [rplan.run()] + [rplan.run(color_mask=m, colors0=c0)
                                     for m, c0 in zip(masks, colors0)]
            del rplan
            if not all(same_result(a, b) for a, b in zip(got, plain, strict=True)):
                raise AssertionError(f"d1 {name}: the pair_scatter kernel's requests "
                                     "differ from scatter='reference'")
            log(f"[main] d1 {name}: 4 requests equal to scatter='reference' in every "
                "field, comm bytes by round and by level included")
        if name == "sparse_delta":
            profile_request("d1 sparse_delta warm",
                            lambda: xplan.run(color_mask=masks[0], colors0=colors0[0]))
            # pair_scatter: the first exchange of the cold request.
            colors, ghost = first_round_inputs(xplan, "d1", device)
            ps_args = first_pairs(xplan, colors, ghost)
            table, slots, vals = ps_args
            width = table.shape[-1]
            log(f"[time] pair_scatter first sparse_delta round: table "
                f"{tuple(table.shape)}, {int((slots < width).sum())} real pairs")
            measured = time_kernel("pair_scatter", pair_scatter, pair_scatter_ref, ps_args,
                                   {}, pair_scatter_bytes(table, slots), args.reps)
            # The one PyTorch call that computes the same function: an
            # out-of-place scatter with the pads routed to a spare column.
            spare = torch.cat([table, torch.zeros_like(table[..., :1])], dim=-1)
            idx = torch.where(slots < width, slots, width).to(torch.int64)
            check_equal("pair_scatter against torch.scatter",
                        torch.scatter(spare, -1, idx, vals)[..., :width],
                        pair_scatter(*ps_args))
            measured["library_ms"] = time_ms(lambda: torch.scatter(spare, -1, idx, vals),
                                             args.reps)
            log(f"[time] pair_scatter library call (torch.scatter): "
                f"{measured['library_ms']:.4f} ms")
            entries["pair_scatter"] = {
                **kernel_entry("pair_scatter", "src/repro_torch/csrc/pair_scatter.cu",
                               "src/repro/kernels/scatter.py:62", measured),
                "library_ms": measured["library_ms"]}
            del colors, ghost, ps_args, table, slots, vals, spare, idx
        del xplan
    del pg
    log(f"[memory] d1: peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")

    # The distance-2 family on the same graph with a second ghost layer.
    t0 = time.perf_counter()
    pg2 = partition_graph(g, args.parts, second_layer=True)
    log(f"[graph] partition with a second ghost layer {time.perf_counter() - t0:.1f} s "
        f"(n_local={pg2.n_local} ghosts={pg2.n_ghost} send={pg2.send_width})")
    for problem in ("d2", "pd2"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rplan = ColoringPlan(pg2, problem=problem, backend="reference", device=device)
        torch.cuda.synchronize()
        log(f"[main] {problem} plan upload {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        refs = [rplan.run()]
        c0 = refs[0].colors.copy()
        c0[masks[0]] = 0
        refs.append(rplan.run(color_mask=masks[0], colors0=c0))
        torch.cuda.synchronize()
        log(f"[main] {problem} reference backend on the card: cold and warm "
            f"{time.perf_counter() - t0:.3f} s (rounds {[r.rounds for r in refs]})")
        del rplan
        for backend, uses in (("cuda", ("d2_assign", "conflict_detect")),
                              ("cuda_fused", ("d2_assign", "fused_round"))):
            kplan = ColoringPlan(pg2, problem=problem, backend=backend, device=device)
            ledger.start()
            got = [ledger.timed(f"{problem} {backend} cold", kplan.run)[0],
                   ledger.timed(f"{problem} {backend} warm 1",
                                lambda: kplan.run(color_mask=masks[0], colors0=c0))[0]]
            ledger.end(f"{problem} {backend}", uses)
            check_results(f"{problem} {backend}", g, problem, got, refs)
            if backend == "cuda_fused":
                fused = got
            if problem == "d2" and backend == "cuda_fused":
                profile_request("d2 cuda_fused warm",
                                lambda: kplan.run(color_mask=masks[0], colors0=c0))
            if problem == "d2" and backend == "cuda":
                # d2_assign: the first launch of the cold run (every active
                # row uncolored).
                st, n = kplan._st, kplan.n_local
                c00, g00, a00, _ = kplan.request_inputs()
                c00, g00, a00 = to_device((c00, g00, a00), device)
                tab = _table(c00, g00)
                entries["d2_assign"] = kernel_entry(
                    "d2_assign", "src/repro_torch/csrc/d2_forbidden.cu",
                    "src/repro/kernels/d2_forbidden.py:89",
                    time_kernel("d2_assign", d2_assign, d2_assign_ref,
                                (st["adj_cidx"], st["ext_adj_cidx"], tab,
                                 torch.ones_like(c00), a00), {"partial_d2": False},
                                d2_assign_bytes(st["adj_cidx"], st["two_hop_cidx"],
                                                tab[:, :n], a00, tab, False),
                                args.reps))
                del st, tab, c00, g00, a00
            if problem == "d2" and backend == "cuda_fused":
                # fused_round on d2: the first round of the cold run, timed
                # for PERF.md beside the d1 entry of the kernels line.
                st = kplan._st
                colors, ghost = first_round_inputs(kplan, "d2", device)
                nbytes, iters = fused_round_bytes(st, colors, ghost, "d2", True)
                log(f"[time] fused_round d2 first-round inputs: the plain fixed "
                    f"point takes {iters} iterations")
                time_kernel("fused_round d2", fused_round, fused_round_ref,
                            (st["adj_cidx"], colors, ghost, st["deg_tab"],
                             st["gid_tab"], st["is_boundary"], st["two_hop_cidx"]),
                            {"problem": "d2"}, nbytes, args.reps)
                del st, colors, ghost
            del kplan
        if problem == "d2":
            # The sparse exchanges on d2, against all_gather on cuda_fused.
            for name in ("sparse_delta", "hier_delta"):
                ledger.start()
                xplan = ColoringPlan(pg2, problem="d2", backend="cuda_fused",
                                     exchange=make_exchange(name, "cuda"), device=device)
                got = [ledger.timed(f"d2 {name} cold", xplan.run)[0],
                       ledger.timed(f"d2 {name} warm 1",
                                    lambda: xplan.run(color_mask=masks[0], colors0=c0))[0]]
                ledger.end(f"d2 {name}", ("d2_assign", "fused_round", "pair_scatter"))
                check_exchange(f"d2 {name}", g, "d2", got, fused)
                del xplan
        log(f"[memory] {problem}: peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            "GiB allocated")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ref = color_distributed(pg2, problem="d1_2gl", backend="reference", device=device)
    for backend in ("cuda", "cuda_fused"):
        ledger.start()
        got, _ = ledger.timed(f"d1_2gl {backend} cold color_distributed",
                              lambda: color_distributed(pg2, problem="d1_2gl",
                                                        backend=backend, device=device))
        ledger.end(f"d1_2gl {backend}", ("vb_bit_assign", "conflict_detect"))
        check_results(f"d1_2gl {backend}", g, "d1_2gl", [got], [ref])
    log(f"[memory] d1_2gl: peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        "GiB allocated")
    del pg2

    # -- 4. the kernels line ----------------------------------------------------
    for name, entry in entries.items():
        entry["launches"] = ledger.total(name)
    log(json.dumps({"kernels": [entries[name] for name in wrappers()]}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(card_identity())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
