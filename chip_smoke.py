#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--graph hex:256,256,256] [--parts 8] [--seed 0]
                          [--baseline-csrc DIR] [--shard-map-only]
                          [--families-only] [--train-only] [--sharded-only]

Run from the root of a checkout.  It exits non-zero on any failure and
prints no result line when ``torch.cuda.is_available()`` is false.  In
order it:

1. prints the card's name and power limit (``nvidia-smi``) and builds
   every CUDA kernel of the port from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all at once), with one ``[ptxas]`` line per
   kernel body (registers, static shared memory, spills); with
   ``--baseline-csrc`` also another version's ``fused_round.cu``,
   ``d2_forbidden.cu``, ``collision.cu`` and ``pair_scatter.cu`` (for
   example the parent commit's);
2. holds each coloring kernel to exact equality with its plain PyTorch
   version on the same CUDA tensors, on random inputs (the shapes of
   ``tests/test_kernels.py`` with 1 and 3 parts, both ``recolor_degrees``
   and ``partial_d2`` settings, cases without ghosts and with one ghost
   slot that holds no real ghost, ragged row counts; ``pair_scatter`` on
   batches of 1 to 64 rows with padding, up to ``S`` pairs and none real;
   ``fused_round`` with ``(slot, color)`` pairs for d1 and d2; the list
   form of ``d2_assign`` on every row, a random subset and none;
   ``collision`` on every active row, a list with part 0 left out and an
   empty one, over each lane block, and its listing launch, and on 1 to
   100 lanes a row over dense, sparse and empty lists; ``pair_scatter``'s
   two bodies also on table rows that are not 16-byte aligned, one row and
   many, all pads and no pads), and
   ``flash_attention`` within 2e-5 (float32) and 2e-2 (bf16) of its plain
   version on the card tests' shapes, every output row within 2e-2 of its
   norm (``[flash]``);
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
     ``sparse_delta`` and ``hier_delta`` (named under a kernel backend, the
     sparse two scatter with ``pair_scatter``), the same four requests on
     one plan each, each equal to ``all_gather``
     (the ``cuda_fused`` requests above) in colors, rounds, conflicts and
     colors used, and the sparse two equal in every field (comm bytes by
     round and by level included) to the same exchange with the plain
     ``scatter="reference"``; their bytes printed; a warm
     ``sparse_delta`` request profiled;
   - on the same graph partitioned with a second ghost layer, ``d2`` and
     ``pd2`` on ``cuda`` and ``cuda_fused``, a cold and a warm 10% request
     each (a ``cuda_fused`` d2 warm request profiled), d2 on ``cuda_fused``
     with ``sparse_delta`` and ``hier_delta`` (``pair_scatter``), cold
     and warm, equal to ``all_gather``, and ``d1_2gl`` cold on both
     backends; the peak device memory after each problem;
   - ``[plans]``: the topology hash a plan key needs (``pg.signature``)
     timed alone, no cold call above having made it; ``get_plan`` twice
     on one ``PlanCache`` (one plan, a
     miss and a hit), four runs of it (the loop built once, ``traces`` 1),
     ``color_distributed`` twice through the default cache (a miss that
     builds the plan, then a hit), the ``nbytes`` of a d1 and a d2 plan
     beside the ``torch.cuda.memory_allocated()`` each adds, and a
     ``PlanCache(max_bytes=...)`` whose d2 plan evicts the d1 plan;
   - ``[reduce]``: ``reduce_colors`` d1 ``cuda_fused`` (2 passes,
     ``reverse``) and d2 ``cuda_fused`` (1 pass), each pass's coloring
     proper and never above the start, with its supersteps, seconds and
     launches, the result equal field by field to the same reduction on
     ``reference`` (d1) or ``cuda`` (d2) on the card; and d2
     ``cuda_fused`` (1 pass) on ``hex:128,128,128`` against
     ``reference``, since ``cuda`` shares ``d2_assign`` and ``collision``;
   - ``[baseline]``: ``color_baseline`` and ``color_jones_plassmann`` on
     d1, each proper, with rounds, colors and seconds;
   - ``[service]``: the continuous-batching service
     (``repro_torch.serve``): ``ColoringService.run_batch`` of 12 warm 10%
     d1 ``cuda_fused`` requests (``max_batch`` 8: a wave of 8, then
     refills) and of 4 warm 10% d2 ``cuda_fused`` requests, each result
     equal in every field to the solo ``plan.run`` of the same request,
     with the batch's wall time beside the solo runs', the service's
     stats, steps, host syncs per step (``count_syncs``) and a carry's
     bytes beside the ``memory_allocated`` growth; and a
     ``ColoringFrontend`` stream of 4 full requests alternating the graph
     and ``hex:128,128,128`` (``sparse_delta`` by name, which scatters
     with ``pair_scatter`` under ``cuda_fused``; one reduction pass),
     replayed cold and warm, each result equal to the
     solo ``plan.run`` + ``reduce_colors``, with ``pg.signature`` at
     first admission timed alone;
   - ``[shard_map]``: the multi-GPU engine over NCCL, one rank per card
     (up to ``--parts``; one card: a group of one in this process, more:
     one spawned process per card, fed the partitions through temporary
     ``.npz`` files), the graph partitioned into one part per rank with a
     second ghost layer: d1 ``cuda_fused`` with every exchange (the sparse
     two in both transports) and d2 with ``sparse_delta``, a cold and a
     warm 10% request each, both run again in one profiler session (NCCL
     calls and kernels > 0), one reduction pass on d1, then the service
     on the group as ``[service]`` drives it: ``ColoringService.run_batch``
     of 12 warm 10% d1 ``cuda_fused`` requests (``max_batch`` 8, refills >
     0) and a ``ColoringFrontend`` stream of 4 alternating the graph and
     ``hex:128,128,128`` (``sparse_delta``, one reduction pass) cold and
     warm, each equal on every rank to its solo run on the engine (plus
     ``reduce_colors``), logged beside ``[service]``'s numbers; every
     rank's result equal in every field to ``simulate`` on the same
     partition on ``cuda:0``; ``--shard-map-only`` builds the kernels and
     runs this phase alone;
   the cold ``color_distributed`` calls above pass ``cache=False``, and
   the default plan cache is emptied between these phases;
4. times each kernel and its plain version (CUDA events, median) on the
   inputs of its first main-path launch, right after the path that makes
   them (``fused_round`` on d1's, with and without pairs, and, for
   ``PERF.md``, on d2's and pd2's; ``d2_assign`` on a cold and a warm d2
   request's first iteration, ``collision`` on the cold one's, beside the
   plain test it replaces, ``collision_losers``, and on a cold d1 and the
   warm d2 request's first iteration; ``pair_scatter`` on the first
   ``sparse_delta`` round's, each body of its C entry, beside the one
   PyTorch call that computes the same function, ``torch.scatter``),
   holds them equal, computes each kernel's bound from the bytes these
   inputs need it to move; splits ``fused_round``'s time into detection (a
   launch with ``max_iters = 0``) and fixed point (``[split]``), the
   baseline's beside it, and times the baseline's ``d2_assign``,
   ``collision`` and ``pair_scatter`` beside this one's in turns;
5. frees the coloring state and serves TinyLlama-1.1B at full width
   (random bf16 weights from ``--seed``) through ``ServeEngine``: a batch
   of four prompts (1,024, 700, 512, 64 tokens; 32 new) and one 16,384
   token request (chunked attention; 8 new), printing prefill and decode
   times, tokens per second, host syncs per step and peak memory, and
   profiling a decode step (``[serve]``); launches ``flash_attention``
   (``kernels.ops``) on layer 0's prefill q, k, v of both as its path,
   holds it (and SDPA) against the model's own attention and, at 1,024,
   its plain version (each element within 2e-2, each row within 2e-2 of
   its norm), and times it beside SDPA against its operations bound, as
   it does a second shape at head width 128 (Qwen3-32B's attention over
   4,096 random bf16 tokens); then checks that a float32 copy of the
   model generates exactly the teacher-forced argmax of ``forward``;
   then ``[serve] families``: every other family of the zoo at full width
   (random bf16 weights from ``--seed``): Qwen3-30B-A3B (MoE) and Grok-1
   (MoE, 2 of its 64 layers) through ``ServeEngine`` on the batch of
   four, Mamba-2 780M (SSM) and Hymba 1.5B (hybrid) on it and on the
   16,384-token request, Llama-3.2-Vision-11B through ``prefill`` with a
   random image and 32 ``decode_step`` calls on 4 prompts of 512 tokens,
   HuBERT-XLarge through ``forward`` over 4 x 1,500 random frames; each
   with its parameters, init, prefill and decode times beside a decode
   step's bytes bound, tokens/s, host syncs a step and peak memory, then a
   float32 copy (the same draws; Qwen3-MoE cut to 8 layers, dropless)
   whose decode logits are held against ``forward`` over the
   teacher-forced rows (tokens equal to its argmax but for printed ties;
   the VLM's logits within 1e-3), prefill's last logits within 1e-4 of
   ``forward``'s for the 16,384 request and HuBERT's frames;
   ``--families-only`` runs this phase alone;
6. trains TinyLlama-1.1B at full width and depth (bf16, remat "full",
   random weights from ``--seed``) through ``train_loop`` (``[train]``):
   4 steps of 8 x 4,096 tokens in 4 microbatches, each with its time,
   tokens per second, loss, ``grad_norm``, ``lr`` and share of 989 TFLOP/s,
   the peak memory, one more step profiled with its host syncs, 2 steps
   with ``compress_grads``, the peak of ``lm_loss`` and its backward pass
   at 2 x 1,024 for remat "none", "dots" and "full" and a 2-layer float32
   copy's gradients equal across the three, and the restart drill at 2 of
   22 layers (a run that fails at step 3 resumes from its step-2
   checkpoint and must end with the uninterrupted run's loss); every loss
   and ``grad_norm`` finite and the last loss below the first;
   ``--train-only`` runs this phase alone; then ``[sharded]``, the sharded
   model stack on a ``DeviceMesh`` of one rank a card (one card: a group of
   one in this process, a ``(1, 1)`` ``("data", "model")`` mesh; four
   cards: one spawned process a card, ``(2, 2)``): Qwen3-30B-A3B at full
   width (bf16, remat "full", ``moe_impl="shard_map"``, experts on
   ``model``), 2 layers a rank, through ``train_loop(mesh=...)``, 3 steps
   of ``2·dp`` x 4,096 tokens in 2 microbatches (each step's time,
   tokens/s, loss, ``grad_norm``; each rank's peak memory), one more step
   profiled on every rank (NCCL calls and kernels, > 0 with more than one
   rank; the top kernels), float32 copies at 2 layers, dropless
   (``capacity_factor`` E/k), of it and of Grok-1 (``moe_shard="tensor"``)
   whose ``shard_map`` and ``gspmd`` MoE logits over 2 x 512 tokens agree
   within 2e-4, and the elastic drill (a 2-layer run's step-2 checkpoint
   from the phase's mesh, its parameters and step restored on ranks 0-1 as
   ``(1, 2)``, on one card with no mesh: the parameters bit-equal to the
   saved ones, the step train_loop resumes at 2); every loss and ``grad_norm``
   finite, every rank the
   same loss; ``--sharded-only`` runs this phase alone; both phases print
   ``[roofline]`` lines: the roofline analysis of their step
   (``repro_torch/roofline/analysis.py`` on meta tensors, in a process of
   its own started with the phase; ``[sharded]``'s as rank 0 of
   its mesh on a fake process group), its FLOPs, bytes, collective bytes
   and calls, peak and three terms, the measured step over the largest
   term, and one more step counted on the card by the analysis' own
   counter: the predicted peak within 10% of the allocator's peak of that
   step, and in ``[sharded]`` every rank's collective calls by kind equal
   to the prediction;
7. prints one ``{"kernels": [...]}`` line with each kernel's launches
   summed over the paths, the ``nvidia-smi`` line, and
   ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core rate, data sheet
BF16_TOL = 2e-2                 # bf16 rounds the output: rtol = atol
# The [serve] phase: TinyLlama-1.1B at full width, random weights from --seed.
SERVE_ARCH = "tinyllama_1_1b"
SERVE_PROMPTS = (1024, 700, 512, 64)    # one batch of 4, left-padded to 1,024
SERVE_NEW = 32
LONG_PROMPT = 16384                     # above attn_chunk_threshold: chunked attention
LONG_NEW = 8
# flash_attention's second shape: Qwen3-32B's attention (64 q heads, 8 kv
# heads, dh 128) over one sequence of 4,096 tokens of random bf16 q, k, v.
WIDE_ARCH = "qwen3_32b"
WIDE_LEN = 4096
# The sources --baseline-csrc builds from another version, each timed in
# turns beside this one's (their C entries must take this source's
# arguments).
BASELINE_SOURCES = ("fused_round", "d2_forbidden", "collision", "pair_scatter")
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
    from repro_torch.kernels.collision import collision
    from repro_torch.kernels.conflict import conflict_detect
    from repro_torch.kernels.d2_forbidden import d2_assign
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_round import fused_round
    from repro_torch.kernels.scatter import pair_scatter
    from repro_torch.kernels.vb_bit import vb_bit_assign

    return {k.__name__: k for k in (vb_bit_assign, conflict_detect, d2_assign, collision,
                                    fused_round, pair_scatter, flash_attention)}


def to_device(arrays, device):
    import torch

    return [torch.from_numpy(a).to(device) for a in arrays]


def random_inputs(n, w, g, n_colors, seed, parts, device):
    """Stacked random kernel inputs on ``device``, as the card tests draw them."""
    from repro_torch.kernels._testing import random_stacked

    _, stacked = random_stacked(n, w, g, n_colors, seed, parts)
    keys = ("adj", "tab", "base", "active", "deg", "gid", "bd")
    return dict(zip(keys, to_device(stacked, device)))


def check_close(name, got, want, tol) -> float:
    """``got`` within ``rtol = atol = tol`` of ``want`` (compared in fp32);
    returns the max absolute difference."""
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        raise AssertionError(f"{name}: differs by up to {err} (rtol = atol = {tol})")
    return err


def check_attention(name, got, want) -> dict:
    """Attention output ``got`` against ``want`` (B, L, H, dh): elementwise
    within ``rtol = atol = BF16_TOL``, and every row within ``ROW_TOL`` of
    ``want``'s row in the 2-norm, relative to that row's norm (which bounds
    each element of the row too).  Returns the max abs error, the max row
    error, mean |want| and how many elements an absolute 1e-3 (with rtol
    BF16_TOL) would fail."""
    import torch

    from repro_torch.kernels._testing import ROW_TOL, max_row_error

    check_close(name, got, want, BF16_TOL)
    row = max_row_error(got, want)
    got, want = got.float(), want.float()
    diff = got - want
    stats = {"max_abs_err": diff.abs().max().item(), "max_row_err": row,
             "mean_abs": want.abs().mean().item(),
             "beyond_1e-3": int((diff.abs() > 1e-3 + BF16_TOL * want.abs()).sum()),
             "elements": want.numel()}
    if not row <= ROW_TOL:
        raise AssertionError(f"{name}: a row differs by {row:.4g} of its norm "
                             f"(limit {ROW_TOL})")
    return stats


def fmt_attention(stats) -> str:
    from repro_torch.kernels._testing import ROW_TOL

    return (f"max abs err {stats['max_abs_err']:.4g} (mean |o| {stats['mean_abs']:.4g}), "
            f"max row err {stats['max_row_err']:.4g} of the row's norm (limit {ROW_TOL}); "
            f"{stats['beyond_1e-3']} of {stats['elements']} elements beyond "
            f"rtol {BF16_TOL} + atol 1e-3")


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
        COLLISION_EDGES, D2_SHAPES, FIXED_POINT_SHAPES, FLASH_SHAPES, ROUND_SHAPES, ROW_TOL,
        SCATTER_EDGES, SCATTER_SHAPES, SHAPES, random_ext, random_fixed_point, random_pairs,
        random_round, round_pairs, scatter_edge,
    )
    from repro_torch.kernels.conflict import conflict_detect, conflict_detect_ref
    from repro_torch.kernels.d2_forbidden import d2_assign, d2_assign_list_ref
    from repro_torch.kernels.fused_round import fused_round, fused_round_ref
    from repro_torch.kernels.scatter import pair_scatter, pair_scatter_ref
    from repro_torch.kernels.vb_bit import vb_bit_assign, vb_bit_assign_ref

    import torch

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
            every = torch.arange(parts * n, dtype=torch.int32, device=device)
            for partial_d2 in (False, True):
                pick = torch.randperm(parts * n, generator=torch.Generator().manual_seed(n))
                for rows in (every, every[pick[:n // 2].to(device)], every[:0]):
                    args = (x["adj"], ext, x["tab"])
                    outs = [[x["base"].clone(), x["tab"][:, :n].clone()] for _ in range(2)]
                    check_equal(f"d2_assign {n, w, g, parts, partial_d2} {len(rows)} rows",
                                d2_assign(*args, *outs[0], rows, partial_d2=partial_d2),
                                d2_assign_list_ref(*args, *outs[1], rows,
                                                   partial_d2=partial_d2))
                    cases["d2_assign"] += 1
    for n, w, g in FIXED_POINT_SHAPES + [(64, 33, 9)]:
        for parts in (1, 3):
            cases["collision"] += collision_grid(
                to_device(random_fixed_point(n, w, g, n + 1, parts), device), n + parts)
    for n, wa, wb, g in COLLISION_EDGES:
        cases["collision"] += collision_edges(n, wa, wb, g, device)
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
    for rows, s, c, k, ps, off in SCATTER_EDGES:
        wide, slots, vals = to_device(scatter_edge(rows, s, c, k, ps, off, rows + s + c), device)
        table = wide[:, off:off + s]
        check_equal(f"pair_scatter {rows, s, c, k, ps, off}", pair_scatter(table, slots, vals),
                    pair_scatter_ref(table, slots, vals))
        cases["pair_scatter"] += 1
    t0 = time.perf_counter()
    worst = flash_grid(device)
    cases["flash_attention"] = sum(n for n, _, _ in worst.values())
    log(f"[flash] {len(FLASH_SHAPES)} shapes x (float32, bfloat16) in "
        f"{time.perf_counter() - t0:.1f} s: the kernel is within 2e-5 (float32) and "
        f"{BF16_TOL} (bfloat16) of its fp32 plain version, every row within {ROW_TOL} of "
        "its norm; max abs err, max row err "
        + ", ".join(f"{dt} {err:.3g}, {row:.3g}" for dt, (_, err, row) in worst.items()))
    return cases


def collision_grid(inputs, seed) -> int:
    """``collision`` against its plain version on one fixed point's random
    state (``random_fixed_point``): its listing launch, then a testing
    launch after new colors land on the active uncolored rows, every part
    running but the last of three, over every active row, a list without
    part 0's rows and an empty list, each lane block and both
    ``recolor_degrees``.  Lists are compared as sets (the kernel fills them
    through atomics).  Returns the case count."""
    import torch

    from repro_torch.kernels.collision import (
        collision, collision_lists, collision_lists_ref, collision_ref,
    )

    adj, _, th, tab, active, deg, gid = inputs
    p, n = active.shape
    i32 = dict(dtype=torch.int32, device=tab.device)
    got = []
    for fn in (collision_lists, collision_lists_ref):
        rows, todo = torch.empty(p * n, **i32), torch.empty(p * n, **i32)
        counts, newc, base = torch.zeros(p + 2, **i32), torch.zeros((p, n), **i32), \
            torch.zeros((p, n), **i32)
        fn(active, tab, rows, todo, counts, newc=newc, base=base)
        got.append((rows[:int(counts[p + 1])].sort().values,
                    todo[:int(counts[p])].sort().values, counts, newc, base))
    check_equal(f"collision lists {p, n}", *got)
    cases = 1
    gen = torch.Generator(device=tab.device).manual_seed(seed)
    todo = active & (tab[:, :n] == 0)
    newc = torch.where(todo, torch.randint(0, 7, todo.shape, generator=gen, **i32), tab[:, :n])
    cur = torch.zeros(p + 2, **i32)
    cur[:p] = todo.any(dim=1).to(torch.int32)
    if p == 3:
        cur[2] = 0
    every = torch.nonzero(active.reshape(-1))[:, 0].to(torch.int32)
    for rows in (every, every[every >= n], every[:0]):
        for lanes in ((adj, None), (th, None), (th, adj)):
            for rd in (True, False):
                got = []
                for fn in (collision, collision_ref):
                    out = [tab.clone(), torch.zeros_like(cur), torch.ones_like(cur),
                           torch.full((p * n,), -1, **i32),
                           torch.ones(len(rows), dtype=torch.bool, device=tab.device)]
                    fn(*lanes, newc, out[0], deg, gid, rows, cur, *out[1:], recolor_degrees=rd)
                    out[3] = out[3][:int(out[1][p])].sort().values
                    got.append(out)
                check_equal(f"collision {p, n, len(rows), lanes[1] is None, rd}", *got)
                cases += 1
    return cases


def collision_edges(n, wa, wb, g, device) -> int:
    """``collision`` against its plain version on one ``COLLISION_EDGES`` shape (three parts, the last
    stopped) over a dense, a sparse (shuffled) and an empty list, both
    ``recolor_degrees``; returns the case count."""
    import torch

    from repro_torch.kernels._testing import collision_lists_of, random_collision
    from repro_torch.kernels.collision import collision, collision_ref

    drawn = random_collision(n, wa, wb, g, n + wa + wb, 3)
    lanes_a, lanes_b, tab, _, deg, gid, newc, cur = (
        None if x is None else torch.from_numpy(x).to(device) for x in drawn)
    cases = 0
    for kind, listed in collision_lists_of(drawn[3], n).items():
        rows = torch.from_numpy(listed).to(device)
        for rd in (True, False):
            got = []
            for fn in (collision, collision_ref):
                out = [tab.clone(), torch.zeros_like(cur), torch.ones_like(cur),
                       torch.full((3 * n,), -1, dtype=torch.int32, device=device),
                       torch.ones(len(rows), dtype=torch.bool, device=device)]
                fn(lanes_a, lanes_b, newc, out[0], deg, gid, rows, cur, *out[1:],
                   recolor_degrees=rd)
                out[3] = out[3][:int(out[1][3])].sort().values
                got.append(out)
            check_equal(f"collision {n, wa, wb, g} {kind} list {rd}", *got)
            cases += 1
    return cases


def flash_grid(device) -> dict:
    """``flash_attention`` against its plain version on the card tests'
    shapes, each in float32 (2e-5) and bfloat16 (2e-2, against the fp32
    plain version of the rounded inputs), and every output row within
    ``ROW_TOL`` of its norm; returns {dtype: (cases, max err, max row err)}."""
    import torch

    from repro_torch.kernels._testing import FLASH_SHAPES, ROW_TOL, max_row_error, random_qkv
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    worst = {}
    for b, lq, lk, hq, hkv, dh, causal, bq, bk in FLASH_SHAPES:
        arrays = to_device(random_qkv(b, lq, lk, hq, hkv, dh, lq + dh), device)
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, BF16_TOL)):
            q, k, v = (t.to(dtype) for t in arrays)
            name = f"flash_attention {b, lq, lk, hq, hkv, dh, causal} {dtype}"
            got = flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
            want = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal)
            err = check_close(name, got, want, tol)
            row = max_row_error(got, want)
            if not row <= ROW_TOL:
                raise AssertionError(f"{name}: a row differs by {row:.4g} of its norm "
                                     f"(limit {ROW_TOL})")
            n, e, r = worst.get(str(dtype), (0, 0.0, 0.0))
            worst[str(dtype)] = (n + 1, max(e, err), max(r, row))
    return worst


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


def graph_ms(fn, reps: int, batches: int = 3) -> float:
    """Device time of one call, the host taken out: ``reps`` calls captured
    in one CUDA graph, the graph replayed between CUDA events, divided by
    ``reps``; the median of ``batches`` replays, after two warm-up calls on
    a side stream and one replay."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    torch.cuda.empty_cache()
    return float(np.median(times))


def count_syncs(fn, sites=None):
    """Run ``fn`` once; returns (its result, the host syncs it made).  A
    list ``sites`` receives each sync's ``file:line``."""
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    synced = [w for w in caught if "synchroniz" in str(w.message)]
    if sites is not None:
        sites += [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in synced]
    return out, len(synced)


def profile_request(label, request, sites=None) -> None:
    """Where one request's time goes: host syncs (each one's ``file:line``
    into a list ``sites``), device busy share, top device activities.  Runs
    the request twice: once counting syncs, once under the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, syncs = count_syncs(request, sites)
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


def d2_assign_bytes(adj, two_hop, rows, n_tab, partial_d2) -> int:
    """Bytes ``d2_assign`` must move on these inputs, each read once.

    Only listed rows are touched: each reads its list entry and base and
    writes its color and base, reads its adjacency row and the extended
    adjacency row of each neighbor (each such row counted once per part),
    and gathers the table entries its lanes name: the two-hop ones, and the
    one-hop ones unless ``partial_d2`` (each distinct entry once per part).
    """
    import torch

    p, n, w = adj.shape
    listed = torch.zeros(p * n, dtype=torch.bool, device=adj.device)
    listed[rows.to(torch.int64)] = True
    listed = listed.view(p, n, 1)
    blocks = [(two_hop, listed.expand_as(two_hop))]
    if not partial_d2:
        blocks.append((adj, listed.expand_as(adj)))
    table = touched_entries(blocks, n_tab)
    ext_rows = distinct_entries(adj, listed.expand_as(adj), n_tab)
    return len(rows) * (4 * 4 + w * 4) + ext_rows * w * 4 + table * 4


def collision_bytes(blocks, newc, tab, deg, gid, rows, cur, recolor_degrees) -> int:
    """Bytes ``collision`` must move on these inputs (a testing launch),
    each read once.

    Every entry is read and its lose byte written; an entry of a running
    part reads its new color and writes its table entry, and with a new
    color reads its lanes, block by block, up to the first one it loses to
    (all of them if none), gathering the color each names (rows' from
    ``newc``, ghosts' from the table: each distinct entry once per part),
    and where the colors collide the lane's gid (and degree, with
    ``recolor_degrees``) and once its own; a row left uncolored writes one
    list entry.  The three count rows are read, added into and zeroed.
    Counted one part at a time, so one part's lanes are the largest
    temporary.
    """
    import torch

    from repro_torch.core.conflict import v_loses

    p, r = newc.shape
    words = 2 if recolor_degrees else 1
    e = rows.to(torch.int64)
    parts = e // r
    tested = cur[parts] > 0
    nbytes = len(e) * (4 + 1) + int(tested.sum()) * (4 + 4) + 3 * (p + 2) * 4
    for q in range(p):
        rq = (e[tested & (parts == q)] - q * r)
        nc = newc[q, rq]
        lanes = torch.cat([b[q, rq] for b in blocks], dim=1).to(torch.int64)   # (L, K)
        cu = torch.where(lanes < r, newc[q].gather(0, lanes.clamp(max=r - 1).view(-1))
                         .view(lanes.shape), tab[q].gather(0, lanes.view(-1)).view(lanes.shape))
        collide = (cu == nc[:, None]) & (nc[:, None] > 0)
        lost = collide & v_loses(nc[:, None], cu, deg[q, rq][:, None], deg[q][lanes],
                                 gid[q, rq][:, None], gid[q][lanes],
                                 recolor_degrees=recolor_degrees)
        k = lanes.shape[1]
        first = torch.where(lost.any(1), lost.to(torch.int8).argmax(1) + 1, k)
        read = (torch.arange(k, device=lanes.device) < first[:, None]) & (nc[:, None] > 0)
        seen = torch.zeros(tab.shape[-1] + 1, dtype=torch.bool, device=tab.device)
        seen[torch.where(read, lanes, tab.shape[-1]).view(-1)] = True
        hit = torch.zeros_like(seen)
        hit[torch.where(read & collide, lanes, tab.shape[-1]).view(-1)] = True
        nbytes += (int(read.sum()) * 4 + int(seen[:-1].sum()) * 4
                   + int(hit[:-1].sum()) * 4 * words
                   + int((read & collide).any(1).sum()) * 4 * words
                   + int(lost.any(1).sum() + (nc == 0).sum()) * 4)
    return nbytes


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
    """Equal in every field (a reduction's merged result has no per-round
    bytes: ``None`` on both sides compares equal)."""
    return (np.array_equal(a.colors, b.colors) and a.rounds == b.rounds
            and a.converged == b.converged
            and a.total_conflicts == b.total_conflicts
            and a.n_colors == b.n_colors
            and a.comm_bytes_total == b.comm_bytes_total
            and a.comm_bytes_per_round == b.comm_bytes_per_round
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


def fused_round_split(label, kargs, kw, reps, baseline=None) -> None:
    """Where ``fused_round``'s time goes on these inputs: the C entry point
    launched with ``max_iters = 0`` (detection, and for a kernel that keeps
    a working table its copy-out) against the wrapper's cap, the rest being
    the fixed point.  With ``baseline`` (another version's library) both
    are timed in turns, baseline, this, this, baseline, after holding the
    two equal."""
    from repro_torch.core.local import MAX_ITERS_D1, MAX_ITERS_D2
    from repro_torch.kernels.build import load
    from repro_torch.kernels.fused_round import launch_kernel

    full = list(kargs) + [None] * (9 - len(kargs))
    cap = MAX_ITERS_D1 if kw["problem"] == "d1" else MAX_ITERS_D2
    libs = {"this": load("fused_round")}
    if baseline is not None:
        libs["baseline"] = baseline
        check_equal(f"fused_round {label}: baseline against this",
                    launch_kernel(baseline, *full, recolor_degrees=True, max_iters=cap, **kw),
                    launch_kernel(libs["this"], *full, recolor_degrees=True, max_iters=cap,
                                  **kw))
    order = ("baseline", "this", "this", "baseline") if baseline is not None else ("this",)
    times = {}
    for name in order:
        per = []
        for iters in (cap, 0):
            per.append(time_ms(lambda: launch_kernel(libs[name], *full, recolor_degrees=True,
                                                     max_iters=iters, **kw), reps))
        times.setdefault(name, []).append(per)
    for name, runs in times.items():
        whole, detect = np.mean(runs, axis=0)
        log(f"[split] fused_round {label}, {name} source: detection {detect:.4f} ms "
            f"(max_iters = 0), fixed point {whole - detect:.4f} ms, whole {whole:.4f} ms "
            f"(mean of {len(runs)})")


def d2_first_iteration(plan, device, color_mask=None, colors0=None):
    """The state of a d2 request's first local iteration on the ``cuda``
    backend (``kernels/ops.py::local_color_d2_cuda``), from the listing
    launch: ``(tab, active, base, newc, todo, rows, counts)``; ``todo`` the
    active uncolored rows, ``rows`` every active row."""
    import torch

    from repro_torch.core.distributed import _table
    from repro_torch.kernels.collision import collision_lists

    c0, g0, a0, _ = plan.request_inputs(color_mask, colors0)
    c0, g0, a0 = to_device((c0, g0, a0), device)
    tab = _table(c0, g0)
    p, n = a0.shape
    i32 = dict(dtype=torch.int32, device=device)
    rows, todo = torch.empty(p * n, **i32), torch.empty(p * n, **i32)
    counts = torch.zeros((3, p + 2), **i32)
    newc, base = torch.empty((p, n), **i32), torch.empty((p, n), **i32)
    collision_lists(a0, tab, rows, todo, counts[0], newc=newc, base=base)
    n_todo, n_rows = counts[0, p:].tolist()
    return tab, a0, base, newc, todo[:n_todo], rows[:n_rows], counts


def time_d2_assign(label, st, state, reps, baseline=None) -> dict:
    """``d2_assign`` on one first iteration's list (``d2_first_iteration``)
    against its plain version and its bytes bound; with ``baseline``
    (another version's library) both timed in turns, baseline, this, this,
    baseline, after holding the baseline equal on the listed rows.  Returns
    the measured keys of its ``{"kernels": [...]}`` entry."""
    import torch

    from repro_torch.kernels.d2_forbidden import d2_assign, d2_assign_list_ref, launch_kernel

    tab, active, base, newc, todo, _, _ = state
    args = (st["adj_cidx"], st["ext_adj_cidx"], tab)
    outs = [[base.clone(), newc.clone()] for _ in range(2)]
    err = check_equal(f"d2_assign {label}", d2_assign(*args, *outs[0], todo),
                      d2_assign_list_ref(*args, *outs[1], todo))
    work = [base.clone(), newc.clone()]
    ms = time_ms(lambda: d2_assign(*args, *work, todo), reps)
    plain_ms = time_ms(lambda: d2_assign_list_ref(*args, *work, todo), max(reps // 4, 3))
    nbytes = d2_assign_bytes(st["adj_cidx"], st["two_hop_cidx"], todo, tab.shape[-1], False)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[time] d2_assign {label}: {len(todo)} rows listed of {active.numel()}; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} B over "
        f"3.35 TB/s), {bound_ms / ms:.1%} of the bound")
    if baseline is not None:
        def run_base(out=work):
            launch_kernel(baseline, *args, *out, todo)
            return out

        e = todo.to(torch.int64)
        check_equal(f"d2_assign {label}: baseline against this on the listed rows",
                    [x.view(-1)[e] for x in run_base([base.clone(), newc.clone()])],
                    [x.view(-1)[e] for x in outs[0]])
        times = {}
        for name in ("baseline", "this", "this", "baseline"):
            fn = run_base if name == "baseline" else (lambda: d2_assign(*args, *work, todo))
            times.setdefault(name, []).append(time_ms(fn, reps))
        log(f"[time] d2_assign {label}, A/B in turns: baseline source "
            f"{np.mean(times['baseline']):.4f} ms, this source {np.mean(times['this']):.4f} ms "
            f"(means of 2: {times})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms}


def d1_first_iteration(plan, device):
    """The state of a cold d1 request's first local iteration on the
    ``cuda`` backend (``kernels/ops.py::local_color_d1_cuda``): ``(tab,
    newc, rows, counts)`` after the listing launch (``rows`` every active
    row) and the first ``vb_bit`` launch (``newc``)."""
    import torch

    from repro_torch.core.distributed import _table
    from repro_torch.kernels.collision import collision_lists
    from repro_torch.kernels.vb_bit import vb_bit_assign

    c0, g0, a0, _ = plan.request_inputs()
    c0, g0, a0 = to_device((c0, g0, a0), device)
    tab = _table(c0, g0)
    p, n = a0.shape
    i32 = dict(dtype=torch.int32, device=device)
    rows, counts = torch.empty(p * n, **i32), torch.zeros((3, p + 2), **i32)
    collision_lists(a0, tab, rows, None, counts[0])
    newc, _ = vb_bit_assign(plan._st["adj_cidx"], tab[:, :n], torch.ones_like(c0), a0, tab)
    return tab, newc, rows[:int(counts[0, p + 1])], counts


def d2_collision_inputs(st, state):
    """``(tab, newc, rows, counts)`` of ``collision`` on a d2 first iteration
    (``d2_first_iteration``), after its ``d2_assign``."""
    from repro_torch.kernels.d2_forbidden import d2_assign

    tab, _, base, newc, todo, rows, counts = state
    newc, base = newc.clone(), base.clone()
    d2_assign(st["adj_cidx"], st["ext_adj_cidx"], tab, base, newc, todo)
    return tab, newc, rows, counts


def time_collision(label, st, blocks, inputs, reps, baseline=None, old_test=None) -> dict:
    """``collision`` on one first iteration's ``inputs`` (``(tab, newc,
    rows, counts)``: ``rows`` every active row, ``counts`` the listing
    launch's three count rows) over the lane ``blocks`` (``lanes_a``,
    ``lanes_b`` or None), against its plain version and its bytes bound;
    ``old_test(tab, newc)``, the whole-table test it replaced, timed beside
    it; with ``baseline`` (another version's library) both timed in turns,
    baseline, this, this, baseline, after holding the baseline equal.
    Returns the measured keys of its ``{"kernels": [...]}`` entry."""
    import torch

    from repro_torch.kernels.collision import collision, collision_ref, launch_kernel

    tab, newc, rows, counts = inputs
    p, n = newc.shape
    lose = torch.empty(len(rows), dtype=torch.bool, device=tab.device)
    got = {}
    runs = {"this": collision, "plain": collision_ref}
    if baseline is not None:
        runs["baseline"] = lambda *args, **kw: launch_kernel(baseline, *args, **kw)
    for name, fn in runs.items():
        c = counts.clone()
        c[1:] = 0
        t = tab.clone()
        fn(*blocks, newc, t, st["deg_tab"], st["gid_tab"], rows, c[0], c[1], c[2],
           rows.new_empty(p * n), lose, recolor_degrees=True)
        got[name] = [t, lose.clone(), c[1]]
    err = check_equal(f"collision {label}", got["this"], got["plain"])
    if baseline is not None:
        check_equal(f"collision {label}: baseline against this", got["baseline"], got["this"])
    c = counts.clone()
    c[1:] = 0
    t = tab.clone()
    left = rows.new_empty(p * n)
    flip = [1, 2]

    def call(fn):               # each call adds into the row the last one zeroed
        flip.reverse()
        fn(*blocks, newc, t, st["deg_tab"], st["gid_tab"], rows, c[0], c[flip[0]],
           c[flip[1]], left, lose, recolor_degrees=True)

    extra = ""
    if old_test is not None:
        if not torch.equal(old_test(tab, newc), got["this"][0]):
            raise AssertionError("collision: the table differs from collision_losers'")
        extra = (f"collision_losers over both blocks + where (the test it replaced) "
                 f"{time_ms(lambda: old_test(tab, newc), 3):.4f} ms, ")
    ms = time_ms(lambda: call(collision), reps)
    plain_ms = time_ms(lambda: call(collision_ref), 3)
    nbytes = collision_bytes([b for b in blocks if b is not None], newc, tab, st["deg_tab"],
                             st["gid_tab"], rows, counts[0], True)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[time] collision {label}: {len(rows)} rows tested, {int(got['this'][2][p])} left "
        f"to color; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, {extra}bound "
        f"{bound_ms:.4f} ms ({nbytes} B over 3.35 TB/s), {bound_ms / ms:.1%} of the bound")
    if baseline is not None:
        times = {}
        for name in ("baseline", "this", "this", "baseline"):
            times.setdefault(name, []).append(time_ms(lambda: call(runs[name]), reps))
        log(f"[time] collision {label}, A/B in turns: baseline source "
            f"{np.mean(times['baseline']):.4f} ms, this source {np.mean(times['this']):.4f} ms "
            f"(means of 2: {times})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms}


def whole_table_test(st, active):
    """The d2 test the collision kernel replaced, as ``local_color_d2_cuda``
    ran it: ``collision_losers`` over both blocks on the table holding the
    new colors, and the ``where`` that zeroed the active losers."""
    import torch

    from repro_torch.core.local import collision_losers

    def old_test(tab, newc):
        n = newc.shape[-1]
        table = tab.clone()
        table[:, :n] = newc
        lost = torch.zeros_like(active)
        for lanes in (st["two_hop_cidx"], st["adj_cidx"]):
            lost |= collision_losers(newc, table, lanes, st["deg_tab"], st["gid_tab"],
                                     recolor_degrees=True)
        table[:, :n] = torch.where(active & lost, 0, newc)
        return table

    return old_test


def time_pair_scatter(ps_args, reps, baseline=None) -> dict:
    """``pair_scatter`` on the first ``sparse_delta`` round's inputs against
    its plain version and its bytes bound, the one PyTorch call that
    computes the same function (``torch.scatter``, its ``library_ms``), the
    table's copy and a read of the slots alone, and, with ``baseline``
    (another version's library), both sources in turns, baseline, this,
    this, baseline, after holding the baseline equal.  A call's device work
    (about 0.05 ms) is of the order of its host cost, so every time here is
    ``graph_ms``'s; the wrapper's back-to-back ``time_ms`` is logged beside
    it.  Returns the measured keys of its ``{"kernels": [...]}`` entry."""
    import torch

    from repro_torch.kernels.scatter import launch_kernel, pair_scatter, pair_scatter_ref

    table, slots, vals = ps_args
    width = table.shape[-1]
    log(f"[time] pair_scatter first sparse_delta round: table {tuple(table.shape)}, "
        f"{int((slots < width).sum())} real pairs")
    want = pair_scatter_ref(*ps_args)
    err = check_equal("pair_scatter main-path inputs", pair_scatter(*ps_args), want)
    ms = graph_ms(lambda: pair_scatter(*ps_args), reps)
    plain_ms = graph_ms(lambda: pair_scatter_ref(*ps_args), reps)
    nbytes = pair_scatter_bytes(table, slots)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[time] pair_scatter: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (device, a CUDA "
        f"graph of {reps} calls), bound {bound_ms:.4f} ms ({nbytes} B over 3.35 TB/s), "
        f"{bound_ms / ms:.1%} of the bound; with the host's launch (back-to-back calls) "
        f"{time_ms(lambda: pair_scatter(*ps_args), reps):.4f} ms")
    # The one PyTorch call that computes the same function: an out-of-place
    # scatter with the pads routed to a spare column.
    spare = torch.cat([table, torch.zeros_like(table[..., :1])], dim=-1)
    idx = torch.where(slots < width, slots, width).to(torch.int64)
    check_equal("pair_scatter against torch.scatter",
                torch.scatter(spare, -1, idx, vals)[..., :width], want)
    library_ms = graph_ms(lambda: torch.scatter(spare, -1, idx, vals), reps)
    # The kernel's two phases, each done alone by PyTorch: the table's copy,
    # and a read of every slot.
    copy_ms = graph_ms(lambda: table.clone(memory_format=torch.contiguous_format), reps)
    slots_ms = graph_ms(lambda: slots.amax(), reps)
    log(f"[time] pair_scatter device: torch.scatter {library_ms:.4f} ms; the table's copy "
        f"alone {copy_ms:.4f} ms, a read of the slots alone {slots_ms:.4f} ms, the two in "
        f"series {copy_ms + slots_ms:.4f} ms")
    if baseline is not None:
        runs = {"baseline": lambda: launch_kernel(baseline, *ps_args),
                "this": lambda: pair_scatter(*ps_args)}
        check_equal("pair_scatter: baseline against this", runs["baseline"](), want)
        times = {}
        for name in ("baseline", "this", "this", "baseline"):
            times.setdefault(name, []).append(graph_ms(runs[name], reps))
        log(f"[time] pair_scatter, A/B in turns (device): baseline source "
            f"{np.mean(times['baseline']):.4f} ms, this source {np.mean(times['this']):.4f} ms "
            f"(means of 2: {times})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "library_ms": library_ms}


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


def leaves(tree):
    """The tensors of a nested parameter dict."""
    for v in tree.values():
        yield from leaves(v) if isinstance(v, dict) else (v,)


def wall_s(fn):
    """Host seconds of ``fn`` run to its end on the card; returns (result, s)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def serve_request(label, eng, prompts, n_new, *, profile=True):
    """Serve ``prompts`` on ``eng`` with ``n_new`` tokens each: prefill and
    decode times (a decode step beside its bytes bound), tokens per second,
    host syncs per decode step, peak memory, the card; with ``profile``, a
    warm-up first and one decode step under the profiler.  Returns the
    tokens."""
    import torch

    from repro_torch.models import decode_step, prefill
    from repro_torch.serve.engine import pad_prompts

    if profile:
        eng.generate(prompts, 1)                               # warm-up
    (_, syncs0), prefill_s = wall_s(lambda: count_syncs(lambda: eng.generate(prompts, 0)))
    torch.cuda.reset_peak_memory_stats()
    (outs, syncs), total_s = wall_s(lambda: count_syncs(lambda: eng.generate(prompts, n_new)))
    peak = torch.cuda.max_memory_allocated() / 2**30
    decode_s = total_s - prefill_s
    n_tok = len(prompts) * n_new
    bound_ms, nbytes = decode_bound(eng.params, eng.cfg, eng.batch, eng.max_len)
    log(f"[serve] {label}: prefill {prefill_s:.4f} s, decode {decode_s / n_new * 1e3:.3f} ms "
        f"per step ({n_new} steps; bound {bound_ms:.3f} ms, {nbytes} B a step over 3.35 "
        f"TB/s), {n_tok / total_s:.1f} tokens/s end to end, {n_tok / decode_s:.1f} tokens/s "
        f"decoding; host syncs per decode step {(syncs - syncs0) / n_new:.2f} (prefill "
        f"only: {syncs0}); peak {peak:.2f} GiB allocated; first tokens "
        f"{[o[:4] for o in outs]}; {card_identity()}")
    if profile:
        toks = torch.from_numpy(pad_prompts(prompts, eng.batch)).to(eng.device)
        with torch.inference_mode():
            logits, cache = prefill(eng.params, eng.cfg, toks, max_len=toks.shape[1] + 2)
            cur = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
            decode_step(eng.params, eng.cfg, cur, cache)
            profile_request(f"serve {label} decode step",
                            lambda: decode_step(eng.params, eng.cfg, cur, cache))
    return outs


def layer0_qkv(params, cfg, toks):
    """Layer 0's q, k, v for the prompt block ``toks``, as prefill's
    ``qkv_project`` makes them."""
    import torch

    from repro_torch.models.layers import qkv_project, rms_norm
    from repro_torch.models.transformer import _unbind

    bp = _unbind(params["blocks"])[0]
    h = rms_norm(params["embed"][toks.long()], bp["ln1"], cfg.norm_eps)
    return qkv_project(bp["attn"], h, cfg, torch.arange(toks.shape[1], device=toks.device))


def flash_bound(q, k, causal=True):
    """(bound ms, "operations" or "bytes", flops, bytes) of one
    ``flash_attention`` call: 4 dh flops per visible (query, key) pair over
    the bf16 tensor-core rate, against q, k, v read and o written once."""
    b, lq, hq, dh = q.shape
    lk = k.shape[1]
    if causal:      # query i sees keys 0..i (top-left)
        n = min(lq, lk)
        pairs = n * (n + 1) // 2 + max(lq - lk, 0) * lk
    else:
        pairs = lq * lk
    flops = 4 * dh * b * hq * pairs
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            flops, nbytes)


def sdpa(q, k, v):
    """The one PyTorch call computing ``flash_attention(causal=True)``: the
    library yardstick (``library_ms``), used nowhere in the port."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
        enable_gqa=True).transpose(1, 2)


def flash_on_path(cfg, qkv, ledger, reps) -> dict:
    """Launch ``kernels.ops.flash_attention`` on the served prompts' layer-0
    q, k, v (counted as the flash path), hold each output against the
    model's own attention (and, at the short shape, the plain version),
    time kernel, plain version and SDPA, and return the kernel's measured
    keys of its ``{"kernels": [...]}`` entry (at the first shape)."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.ops import flash_attention
    from repro_torch.models.layers import attention_chunked, attention_dense

    ledger.start()
    outs = {label: flash_attention(*t, causal=True) for label, t in qkv.items()}
    torch.cuda.synchronize()
    ledger.end("serve flash_attention (kernels.ops.flash_attention on layer 0's "
               "prefill q, k, v)", ("flash_attention",))
    entry = None
    for label, (q, k, v) in qkv.items():
        o = outs[label]
        lq = q.shape[1]
        pos = torch.arange(lq, device=q.device)
        if lq > cfg.attn_chunk_threshold:
            name = "attention_chunked"
            model = attention_chunked(q, k, v, pos, pos, causal=True,
                                      q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk)
        else:
            name = "attention_dense"
            model = attention_dense(q, k, v, pos, pos, causal=True)
        vs_model = check_attention(f"flash_attention {label} vs the model's {name}", o, model)
        del model
        vs_sdpa = check_attention(f"SDPA {label} vs flash_attention", sdpa(q, k, v), o)
        long = lq > cfg.attn_chunk_threshold
        ms = time_ms(lambda: flash_attention(q, k, v, causal=True), 3 if long else reps)
        library_ms = time_ms(lambda: sdpa(q, k, v), reps)
        bound_ms, bound_by, flops, nbytes = flash_bound(q, k)
        msg = (f"[time] flash_attention {label} q {tuple(q.shape)} k {tuple(k.shape)} "
               f"{q.dtype}: kernel {ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
               f"{bound_ms:.4f} ms ({flops} flop over 989 TFLOP/s, {nbytes} B over "
               f"3.35 TB/s: bound by {bound_by}), {bound_ms / ms:.2%} of the bound; "
               f"vs the model's {name}: {fmt_attention(vs_model)}; SDPA vs the kernel: "
               f"{fmt_attention(vs_sdpa)}")
        if long:
            log(msg + "; the dense plain version (a 34 GB score matrix at 16,384) "
                "is neither run nor timed")
            continue
        plain = flash_attention_ref(q, k, v, causal=True)
        vs_plain = check_attention(f"flash_attention {label} vs its plain version", o, plain)
        del plain
        plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, causal=True),
                           max(reps // 4, 3))
        log(msg + f"; plain {plain_ms:.4f} ms, vs plain: {fmt_attention(vs_plain)}")
        if entry is None:
            entry = {"max_abs_err": vs_plain["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
    return entry


def flash_wide(device, seed, reps) -> None:
    """``flash_attention`` at ``WIDE_ARCH``'s attention width (dh 128) on
    random bf16 q, k, v of one ``WIDE_LEN``-token sequence from ``seed``:
    held against the port's model attention at that length and against
    SDPA, timed beside SDPA against its operations bound.  Its launches
    compare and time; they belong to no path."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import flash_attention
    from repro_torch.models.layers import attention_chunked, attention_dense

    cfg = get_config(WIDE_ARCH)
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((1, WIDE_LEN, cfg.n_heads, cfg.head_dim), generator=gen, device=device)
    k, v = (torch.randn((1, WIDE_LEN, cfg.n_kv_heads, cfg.head_dim), generator=gen,
                        device=device) for _ in range(2))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    o = flash_attention(q, k, v, causal=True)
    pos = torch.arange(WIDE_LEN, device=device)
    if WIDE_LEN > cfg.attn_chunk_threshold:
        name = "attention_chunked"
        model = attention_chunked(q, k, v, pos, pos, causal=True, q_chunk=cfg.attn_q_chunk,
                                  k_chunk=cfg.attn_k_chunk)
    else:
        name = "attention_dense"
        model = attention_dense(q, k, v, pos, pos, causal=True)
    vs_model = check_attention(f"flash_attention {cfg.name} vs the model's {name}", o, model)
    del model
    vs_sdpa = check_attention(f"SDPA {cfg.name} vs flash_attention", sdpa(q, k, v), o)
    ms = time_ms(lambda: flash_attention(q, k, v, causal=True), reps)
    library_ms = time_ms(lambda: sdpa(q, k, v), reps)
    bound_ms, bound_by, flops, nbytes = flash_bound(q, k)
    log(f"[time] flash_attention {cfg.name} 1x{WIDE_LEN} q {tuple(q.shape)} k "
        f"{tuple(k.shape)} {q.dtype} (random, seed {seed}): kernel {ms:.4f} ms, SDPA "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({flops} flop over 989 TFLOP/s, "
        f"{nbytes} B over 3.35 TB/s: bound by {bound_by}), {bound_ms / ms:.2%} of the bound; "
        f"vs the model's {name}: {fmt_attention(vs_model)}; SDPA vs the kernel: "
        f"{fmt_attention(vs_sdpa)}")


def serve_phase(device, seed, cfg, ledger, reps) -> dict:
    """Serve ``cfg`` (bf16) through ``ServeEngine``: the batch of four, then
    the long request; the kernel on their layer-0 q, k, v; then the float32
    check at the same width.  Returns ``flash_attention``'s measured keys."""
    import dataclasses

    import torch

    from repro_torch.models import forward, init_params, prefill
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import pad_prompts

    rng = np.random.default_rng(seed)
    batch = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in SERVE_PROMPTS]
    long = [rng.integers(1, cfg.vocab_size, LONG_PROMPT).astype(np.int32)]
    if LONG_PROMPT <= cfg.attn_chunk_threshold:
        raise AssertionError("the long request must take the chunked attention")
    requests = ((f"{len(batch)}x{max(SERVE_PROMPTS)}", batch, SERVE_NEW),
                (f"1x{LONG_PROMPT}", long, LONG_NEW))

    torch.cuda.empty_cache()
    params, init_s = wall_s(lambda: init_params(
        cfg, torch.Generator(device=device).manual_seed(seed)))
    n_params = sum(t.numel() for t in leaves(params))
    log(f"[serve] {cfg.name} ({cfg.dtype}): {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} q heads, {cfg.n_kv_heads} kv heads, dh {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}: {n_params} random parameters (seed "
        f"{seed}) in {init_s:.2f} s")
    ledger.start()
    qkv = {}
    for label, prompts, n_new in requests:
        eng = ServeEngine(cfg, params, batch=len(prompts),
                          max_len=max(map(len, prompts)) + n_new, device=device)
        serve_request(label, eng, prompts, n_new)
        with torch.inference_mode():
            toks = torch.from_numpy(pad_prompts(prompts, len(prompts))).to(device)
            qkv[label] = layer0_qkv(params, cfg, toks)
    ledger.end(f"serve {cfg.dtype} (attention in plain PyTorch, as in repro)", ())
    del params
    with torch.inference_mode():
        entry = flash_on_path(cfg, qkv, ledger, reps)
        del qkv
        flash_wide(device, seed, reps)

    # The float32 check at the same width: the same draws, not rounded.
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(cfg32, torch.Generator(device=device).manual_seed(seed))
    (label, prompts, n_new), (long_label, _, long_new) = requests
    eng = ServeEngine(cfg32, params, batch=len(prompts),
                      max_len=max(map(len, prompts)) + n_new, device=device)
    outs, s32 = wall_s(lambda: eng.generate(prompts, n_new))
    toks = pad_prompts(prompts, len(prompts))
    lp = toks.shape[1]
    with torch.inference_mode():
        for i, out in enumerate(outs):
            row = torch.from_numpy(np.concatenate([toks[i], out]).astype(np.int32))
            logits, _ = forward(params, cfg32, row[None].to(device))
            want = torch.argmax(logits[0, lp - 1:lp - 1 + n_new], dim=-1).tolist()
            if want != out:
                t = next(j for j, (a, b) in enumerate(zip(want, out)) if a != b)
                raise AssertionError(f"[serve] float32 {label} row {i}: token {t} is "
                                     f"{out[t]}, the teacher-forced argmax {want[t]}")
    log(f"[serve] float32 {label} ({s32:.3f} s): all {len(outs)} x {n_new} generated "
        "tokens equal the argmax of forward over the left-padded rows (prompt, pads "
        "and generated tokens)")
    eng = ServeEngine(cfg32, params, batch=1, max_len=LONG_PROMPT + long_new, device=device)
    outs, s32 = wall_s(lambda: eng.generate(long, long_new))
    with torch.inference_mode():
        toks = torch.from_numpy(long[0][None]).to(device)
        last, _ = prefill(params, cfg32, toks, max_len=LONG_PROMPT + long_new)
        logits, _ = forward(params, cfg32, toks)
        err = check_close(f"float32 {long_label}: prefill's last logits vs forward's",
                          last[:, -1], logits[:, -1], 1e-4)
        first = int(torch.argmax(logits[0, -1]))
    if outs[0][0] != first:
        raise AssertionError(f"[serve] float32 {long_label}: first token {outs[0][0]}, "
                             f"forward's argmax {first}")
    log(f"[serve] float32 {long_label} ({s32:.3f} s): first token {first} equals "
        f"forward's argmax; prefill's last logits within {err:.3g} of forward's "
        f"(tokens {outs[0]})")
    return entry


# The [serve] families phase: every other family of the zoo, random bf16
# weights from --seed.  (arch, layers served in bf16, layers of the float32
# check copy); None keeps the published depth.  Grok-1's 64 layers would be
# 633 GB in bf16; Qwen3-MoE's float32 copy at 48 layers, 122 GB.
FAMILY_RUNS = (
    ("qwen3_moe_30b_a3b", None, 8),
    ("grok_1_314b", 2, 2),
    ("mamba2_780m", None, None),
    ("hymba_1_5b", None, None),
    ("llama_3_2_vision_11b", None, None),
    ("hubert_xlarge", None, None),
)
SSM_FAMILIES = ("ssm", "hybrid")        # served the long request too
VLM_PROMPT = (4, 512)                   # the VLM: 4 prompts of 512 tokens, 32 new
AUDIO_FRAMES = (4, 1500)                # HuBERT: 4 x 30 s of 50 frames/s
FAMILY_TOL = 1e-4                       # prefill's last logits against forward's
VLM_TOL = 1e-3                          # float32 decode logits against forward's


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def decode_bound(params, cfg, batch, max_len) -> tuple[float, int]:
    """(ms, bytes) of one decode step at 3.35 TB/s: every weight read once
    (MoE decode is dropless, so every expert; the embedding only as the tied
    head, a step gathers ``batch`` rows of it otherwise) and every cache
    tensor read once."""
    from repro_torch.models import init_cache

    nbytes = tree_bytes(params) + tree_bytes(init_cache(cfg, batch, max_len, device="meta"))
    if not cfg.tie_embeddings:
        nbytes -= params["embed"].numel() * params["embed"].element_size()
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def greedy(params, cfg, toks, n_new, *, img=None, forced=None):
    """prefill, then ``n_new`` decode steps, as ``ServeEngine.generate`` runs
    them (one bulk token read a step), the next token the argmax or, with
    ``forced`` (B, n_new), forced.  Returns (tokens (B, n_new) as numpy,
    the logits that chose them (B, n_new, V), float32)."""
    import torch

    from repro_torch.models import decode_step, prefill

    with torch.inference_mode():
        logits, cache = prefill(params, cfg, toks, img=img, max_len=toks.shape[1] + n_new)
        out, steps = [], []
        for t in range(n_new):
            steps.append(logits[:, -1].float())
            cur = (torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
                   if forced is None else forced[:, t:t + 1])
            out.append(cur[:, 0].cpu().numpy())
            logits, cache = decode_step(params, cfg, cur, cache)
    return np.stack(out, axis=1), torch.stack(steps, dim=1)


def family_line(cfg, depth, n_params, nbytes, init_s, ident) -> str:
    cut = (f"{cfg.n_layers} of {depth} layers: the published depth cut" if cfg.n_layers != depth
           else f"all {depth} layers")
    return (f"[serve] families {cfg.name} ({cfg.family}, {cfg.dtype}, {cut}): {n_params} "
            f"random parameters, {nbytes / 1e9:.2f} GB, init {init_s:.2f} s; {ident}")


def check_decode(label, params, cfg, toks, outs, served, *, img=None, tol=None) -> float:
    """Hold decoding against ``forward`` over each teacher-forced row
    (prompt, pads, generated tokens): the measured max |logit| error between
    the logits that chose each token (``served``) and ``forward``'s at its
    position, at most ``tol`` where given; every token ``forward``'s argmax
    unless ``forward``'s top two logits there lie within twice that error
    (each may move by it), a tie that is printed.  Returns the error."""
    import torch

    from repro_torch.models import forward

    lp, n_new = toks.shape[1], outs.shape[1]
    want = []
    with torch.inference_mode():
        for i in range(len(outs)):
            row = torch.from_numpy(np.concatenate([toks[i], outs[i]]).astype(np.int32))
            logits, _ = forward(params, cfg, row[None].to(served.device),
                                img=None if img is None else img[i:i + 1])
            want.append(logits[0, lp - 1:lp - 1 + n_new].float())
    want = torch.stack(want)
    err = float((served - want).abs().max())
    if tol is not None and not err <= tol:
        raise AssertionError(f"[serve] families float32 {label}: decode logits {err:.3g} "
                             f"from forward's, over {tol}")
    top = torch.topk(want, 2, dim=-1)
    ties = []
    for i, t in zip(*np.nonzero(torch.argmax(want, dim=-1).cpu().numpy() != outs)):
        gap = float(want[i, t, top.indices[i, t, 0]] - want[i, t, outs[i, t]])
        if gap > 2 * err:
            raise AssertionError(f"[serve] families float32 {label} row {i}: token {t} is "
                                 f"{outs[i, t]}, forward's argmax {int(top.indices[i, t, 0])} "
                                 f"by {gap:.3g}, over twice the error {err:.3g}")
        ties.append((int(i), int(t), gap))
    log(f"[serve] families float32 {label}: all {outs.size} tokens forward's teacher-forced "
        f"argmax over the teacher-forced rows (prompt, pads, generated tokens)"
        + (f" but {len(ties)} ties (row, token, top-two gap) {ties}" if ties else "")
        + f"; decode logits within {err:.3g} of forward's"
        + (f" (limit {tol})" if tol is not None else ""))
    return err


def family_tokens(cfg, rng, lengths):
    return [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in lengths]


def serve_family(arch, depth, check_depth, device, seed, ident) -> None:
    """One family: bf16 at full width (depth cut where ``depth`` says),
    served as a user would call it, then the float32 check."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params, prefill
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import pad_prompts

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=depth or full.n_layers)
    rng = np.random.default_rng(seed)
    torch.cuda.empty_cache()
    params, init_s = wall_s(lambda: init_params(
        cfg, torch.Generator(device=device).manual_seed(seed)))
    log(family_line(cfg, full.n_layers, sum(t.numel() for t in leaves(params)),
                    tree_bytes(params), init_s, ident))

    if cfg.frontend_dim:                          # the audio encoder: forward over frames
        b, l = AUDIO_FRAMES
        gen = torch.Generator(device=device).manual_seed(seed)
        frames = torch.randn((b, l, cfg.frontend_dim), generator=gen, device=device)
        with torch.inference_mode():
            forward(params, cfg, None, frames=frames)          # warm-up
            torch.cuda.reset_peak_memory_stats()
            logits, s = wall_s(lambda: forward(params, cfg, None, frames=frames)[0])
        log(f"[serve] families {cfg.name} forward {b}x{l} frames: {s:.4f} s, "
            f"{b * l / s:.1f} frames/s, {b * l / 50 / s:.1f} s of audio a second; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated; {ident}")
    elif cfg.n_cross_layers:                      # the VLM: prefill with the image, then decode
        b, l = VLM_PROMPT
        toks = np.stack(family_tokens(cfg, rng, [l] * b))
        gen = torch.Generator(device=device).manual_seed(seed)
        img = torch.randn((b, cfg.vision_seq, cfg.d_model), generator=gen,
                          device=device).to(params["embed"].dtype)
        ttoks = torch.from_numpy(toks).to(device)
        greedy(params, cfg, ttoks, 1, img=img)                  # warm-up
        with torch.inference_mode():
            _, prefill_s = wall_s(lambda: prefill(params, cfg, ttoks, img=img,
                                                  max_len=l + SERVE_NEW))
        torch.cuda.reset_peak_memory_stats()
        ((outs, _), syncs), total_s = wall_s(lambda: count_syncs(
            lambda: greedy(params, cfg, ttoks, SERVE_NEW, img=img)))
        decode_s = total_s - prefill_s
        bound_ms, nbytes = decode_bound(params, cfg, b, l + SERVE_NEW)
        log(f"[serve] families {cfg.name} {b}x{l} with a {cfg.vision_seq}-token image: "
            f"prefill {prefill_s:.4f} s, decode {decode_s / SERVE_NEW * 1e3:.3f} ms per step "
            f"({SERVE_NEW} decode_step calls; bound {bound_ms:.3f} ms, {nbytes} B a step over "
            f"3.35 TB/s), {b * SERVE_NEW / total_s:.1f} tokens/s end to end, "
            f"{b * SERVE_NEW / decode_s:.1f} tokens/s decoding; host syncs per decode step "
            f"{syncs / SERVE_NEW:.2f}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB allocated; first tokens {outs[:, :4].tolist()}; {ident}")
    else:                                         # served through ServeEngine
        requests = [(f"{len(SERVE_PROMPTS)}x{max(SERVE_PROMPTS)}",
                     family_tokens(cfg, rng, SERVE_PROMPTS), SERVE_NEW)]
        if cfg.family in SSM_FAMILIES:
            requests.append((f"1x{LONG_PROMPT}", family_tokens(cfg, rng, [LONG_PROMPT]),
                             LONG_NEW))
        for i, (label, prompts, n_new) in enumerate(requests):
            eng = ServeEngine(cfg, params, batch=len(prompts),
                              max_len=max(map(len, prompts)) + n_new, device=device)
            serve_request(f"families {cfg.name} {label}", eng, prompts, n_new,
                          profile=i == 0)
            del eng

    # The float32 check: the same draws, not rounded, at check_depth.
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=check_depth or cfg.n_layers)
    if cfg.is_moe:      # forward dropless, as decode is
        cfg32 = dataclasses.replace(cfg32, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    params = init_params(cfg32, torch.Generator(device=device).manual_seed(seed))
    what = (f"{cfg32.n_layers} of {full.n_layers} layers ({tree_bytes(params) / 1e9:.2f} GB"
            + (f"; capacity_factor {cfg32.capacity_factor}" if cfg.is_moe else "") + ")")
    t0 = time.perf_counter()
    if cfg.frontend_dim:
        with torch.inference_mode():
            last, _ = prefill(params, cfg32, None, frames=frames)
            logits, _ = forward(params, cfg32, None, frames=frames)
            if not torch.isfinite(logits).all():
                raise AssertionError(f"[serve] families float32 {cfg.name}: logits not finite")
            err = check_close(f"families float32 {cfg.name}: prefill's last logits vs forward's",
                              last[:, -1], logits[:, -1], FAMILY_TOL)
        log(f"[serve] families float32 {cfg.name} {what}: all {logits.numel()} logits of "
            f"forward finite; prefill's last logits within {err:.3g} of forward's last row "
            f"({time.perf_counter() - t0:.1f} s)")
        return
    if cfg.n_cross_layers:
        img32 = img.float()
        outs, served = greedy(params, cfg32, ttoks, SERVE_NEW, img=img32)
        err = check_decode(f"{cfg.name} {what}", params, cfg32, toks, outs, served,
                           img=img32, tol=VLM_TOL)
        log(f"[serve] families float32 {cfg.name}: checked in {time.perf_counter() - t0:.1f} s")
        return
    label, prompts, n_new = requests[0]
    eng = ServeEngine(cfg32, params, batch=len(prompts),
                      max_len=max(map(len, prompts)) + n_new, device=device)
    outs = np.array(eng.generate(prompts, n_new))
    toks = pad_prompts(prompts, len(prompts))
    # The logits that chose generate's tokens: its prefill and decode steps
    # replayed with its tokens forced (the same computation, so the same
    # tokens).
    replay, served = greedy(params, cfg32, torch.from_numpy(toks).to(device), n_new,
                            forced=torch.from_numpy(outs.astype(np.int32)).to(device))
    if not (replay == outs).all():
        raise AssertionError(f"[serve] families float32 {cfg.name}: a replay of generate's "
                             "steps chose other tokens")
    check_decode(f"{cfg.name} {label} {what}", params, cfg32, toks, outs, served)
    for label, prompts, n_new in requests[1:]:
        with torch.inference_mode():
            t = torch.from_numpy(prompts[0][None]).to(device)
            last, _ = prefill(params, cfg32, t, max_len=len(prompts[0]) + n_new)
            logits, _ = forward(params, cfg32, t)
            err = check_close(f"families float32 {cfg.name} {label}: prefill's last logits "
                              "vs forward's", last[:, -1], logits[:, -1], FAMILY_TOL)
        log(f"[serve] families float32 {cfg.name} {label}: prefill's last logits within "
            f"{err:.3g} of forward's")
    log(f"[serve] families float32 {cfg.name}: checked in {time.perf_counter() - t0:.1f} s")


def families_phase(device, seed, ledger) -> None:
    """``[serve] families``: every family of the zoo beside the dense one,
    each through the entry points a user calls, then its float32 check.
    Their path launches no kernel: ``repro``'s model code calls plain
    attention, and its MoE and SSD layers are einsums."""
    t0 = time.perf_counter()
    ident = card_identity()
    ledger.start()
    for arch, depth, check_depth in FAMILY_RUNS:
        serve_family(arch, depth, check_depth, device, seed, ident)
    ledger.end("serve families (plain PyTorch, as in repro)", ())
    log(f"[serve] families: the phase took {time.perf_counter() - t0:.1f} s; {ident}")


# The [train] phase: TinyLlama-1.1B trained at its published width and depth
# (bf16, remat "full"), random weights from --seed.
TRAIN_ARCH = "tinyllama_1_1b"
TRAIN_SEQ = 4096                # the train_4k shape's sequence length
TRAIN_BATCH = 8                 # train_4k's global batch of 256, cut to fit the script
TRAIN_MICROBATCHES = 4          # microbatches of 2 x 4,096: accumulation runs
TRAIN_STEPS = 4
TRAIN_COMPRESSED_STEPS = 2      # compress_grads=True
REMAT_SHAPE = (2, 1024)         # a backward pass that fits without remat
REMAT_CHECK_LAYERS = 2          # the float32 copy whose gradients remat must not move
DRILL_LAYERS = 2                # the restart drill: 2 of 22 layers, full width
DRILL_STEPS, DRILL_FAIL, DRILL_EVERY = 4, 3, 2


def train_flops(cfg, batch, seq) -> float:
    """Model FLOPs of one training step of a dense config, PaLM's count
    (arXiv:2204.02311, appendix B): 6 a token for every weight of a product
    (the LM head included, the embedding gather not), plus 12 * layers *
    q heads * head dim * seq a token for the attention's two products,
    forward and backward, the whole square (the causal half is computed
    too); remat's recomputation not counted."""
    d, dh = cfg.d_model, cfg.head_dim
    per_layer = d * dh * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * dh * d \
        + 3 * d * cfg.d_ff
    weights = cfg.n_layers * per_layer + d * cfg.vocab_size
    return batch * seq * (6 * weights + 12 * cfg.n_layers * cfg.n_heads * dh * seq)


ROOFLINE_PEAK_BOUND = 0.10      # |predicted / measured peak - 1| allowed (PERF.md)
ROOFLINE_LIMIT_S = 600          # the wait for the analysis' process


def roofline_prediction(phase: str, world: int = 1):
    """:func:`predict_step` started in a spawned process of its own (the
    fake process group cannot share a process with the phases' real one),
    so that it runs while the phase works on the card: the future of its
    record.  The process ends with its work."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(1, mp_context=mp.get_context("spawn"))
    future = pool.submit(predict_step, phase, world)
    pool.shutdown(wait=False)
    return future


def predict_step(phase: str, world: int) -> dict:
    """The roofline analysis (``repro_torch/roofline/analysis.py``) of the
    step that ``phase`` runs, built as that phase builds it, on meta
    tensors: ``[train]``'s ("train") on one card with no mesh,
    ``[sharded]``'s ("sharded") as rank 0 of its ``world``-rank mesh on a
    fake process group."""
    import dataclasses

    import torch

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.mesh import dp_axes
    from repro_torch.launch.train import to_device
    from repro_torch.models import init_params
    from repro_torch.models.layers import ShapesOnly
    from repro_torch.models.sharding import make_activation_policy, shard_params, use_policy
    from repro_torch.roofline.analysis import analyze_step, fake_mesh, fake_process_group
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.step import make_train_step

    def batch(cfg, rows, seq, mesh=None):
        data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=rows, seed=0)
        return to_device(data.batch_at(0), torch.device("meta"), mesh)

    t0 = time.perf_counter()
    if phase == "train":
        cfg = dataclasses.replace(get_config(TRAIN_ARCH), remat="full")
        fn = make_train_step(cfg, OptimizerConfig(total_steps=TRAIN_STEPS),
                             microbatches=TRAIN_MICROBATCHES)
        params = init_params(cfg, ShapesOnly())
        args = (params, init_opt_state(params), batch(cfg, TRAIN_BATCH, TRAIN_SEQ))
        rec = analyze_step(fn, args, cfg, ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
                           None)
    else:
        shape = sharded_shape(world)
        with fake_process_group(world):
            mesh = fake_mesh(shape, ("data", "model"))
            cfg = dataclasses.replace(get_config(SHARDED_ARCH), n_layers=SHARDED_LAYERS * world,
                                      moe_impl="shard_map")
            fn = make_train_step(cfg, OptimizerConfig(total_steps=SHARDED_STEPS),
                                 microbatches=SHARDED_MICROBATCHES)
            params = shard_params(init_params(cfg, ShapesOnly()), cfg, mesh)
            rows = 2 * shape[0]
            args = (params, init_opt_state(params), batch(cfg, rows, SHARDED_SEQ, mesh))
            with use_policy(make_activation_policy(mesh, cfg, dp=dp_axes(mesh))):
                rec = analyze_step(fn, args, cfg,
                                   ShapeSpec("train", SHARDED_SEQ, rows, "train"), mesh)
    rec["analysis_s"] = time.perf_counter() - t0
    return rec


def counted_step(step_fn, params, opt_state, batch, policy=None) -> dict:
    """One training step on the card under the roofline analysis' own
    counter (``count_step``): its collective calls and bytes by kind, the
    counter's peak of live tensors, the step's seconds, and the allocator's
    peak less what was held before the step beyond the step's arguments."""
    import torch

    from repro_torch.models.sharding import use_policy
    from repro_torch.roofline.analysis import count_step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with use_policy(policy):
        c = count_step(step_fn, (params, opt_state, batch))
    torch.cuda.synchronize()
    args = c["argument_size_in_bytes"]
    return {"calls": c["collective_calls_per_dev"], "bytes": c["collective_bytes_per_dev"],
            "step_s": time.perf_counter() - t0, "args": args,
            "tally": c["peak_memory_in_bytes"],
            "peak": torch.cuda.max_memory_allocated() - (held - args), "held": held}


def roofline_line(label: str, rec: dict) -> str:
    """A ``[roofline]`` line of one predicted step."""
    from repro_torch.roofline.analysis import CARD

    coll = {k: int(v) for k, v in rec["collective_bytes_per_dev"].items()}
    return (f"[roofline] {label} predicted (meta tensors, {rec['chips']} chip(s); "
            f"{rec['analysis_s']:.1f} s in a process of its own): FLOPs "
            f"{rec['hlo_flops_per_dev']:.6e}, bytes {rec['hlo_bytes_per_dev']:.6e}, collective "
            f"bytes {coll} (calls {rec['collective_calls_per_dev']}), arguments "
            f"{rec['argument_size_in_bytes'] / 2**30:.3f} GiB, peak "
            f"{rec['peak_memory_in_bytes'] / 2**30:.3f} GiB; terms compute "
            f"{rec['compute_s']:.6f} s, memory {rec['memory_s']:.6f} s, collective "
            f"{rec['collective_s']:.6f} s, dominant {rec['dominant']}; useful_flops_ratio "
            f"{rec['useful_flops_ratio']:.4f} (data-sheet constants of {CARD})")


def check_peak(label: str, predicted: int, measured: float) -> float:
    """The predicted peak over the measured one; fails beyond the bound."""
    ratio = predicted / measured
    if not abs(ratio - 1) <= ROOFLINE_PEAK_BOUND:
        raise AssertionError(f"[roofline] {label}: predicted peak {predicted} B against "
                             f"{measured:.0f} B measured (ratio {ratio:.4f}, bound "
                             f"{ROOFLINE_PEAK_BOUND})")
    return ratio


def train_phase(device, seed, ledger) -> None:
    """``[train]``: TinyLlama-1.1B trained through ``train_loop`` at full width
    and depth (bf16, remat "full", 8 x 4,096 tokens a step in 4 microbatches),
    a profiled step, a compressed run, the peaks of the three remat modes
    and a float32 copy's gradients across them, and the restart drill.
    The path launches no kernel: ``repro``'s model calls plain attention."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.train import to_device, train_loop
    from repro_torch.models import init_params, lm_loss
    from repro_torch.train import checkpoint
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.step import make_train_step
    from repro_torch.train.tree import flatten

    t_phase = time.perf_counter()
    prediction = roofline_prediction("train")
    ident = card_identity()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), remat="full")
    b, l, mb = TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICROBATCHES
    flops = train_flops(cfg, b, l)
    kw = dict(global_batch=b, seq_len=l, microbatches=mb, seed=seed, device=device,
              log_every=1)
    log(f"[train] {cfg.name} ({cfg.dtype}, remat {cfg.remat!r}, all {cfg.n_layers} layers, "
        f"{cfg.param_count()} parameters): {b} x {l} tokens a step in {mb} microbatches of "
        f"{b // mb}; {flops / 1e12:.1f} model TFLOP a step; {ident}")

    # The run a user starts: train_loop, TRAIN_STEPS steps.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()        # left by earlier phases, not the run's
    ledger.start()
    params, hist = train_loop(cfg, steps=TRAIN_STEPS, **kw)
    torch.cuda.synchronize()
    ledger.end("train (plain PyTorch, as in repro)", ())
    peak_bytes = torch.cuda.max_memory_allocated() - base
    peak = peak_bytes / 2**30
    log(f"[train] parameters {sum(t.numel() for t in leaves(params))}, "
        f"{tree_bytes(params) / 1e9:.2f} GB")
    for h in hist:
        log(f"[train] step {h['step']}: {h['step_time']:.4f} s, {b * l / h['step_time']:.1f} "
            f"tokens/s, loss {h['loss']:.6f}, grad_norm {h['grad_norm']:.6f}, lr "
            f"{h['lr']:.6g}; model FLOPs over 989 TFLOP/s bf16 "
            f"{flops / h['step_time'] / BF16_FLOPS:.2%}; {ident}")
    log(f"[train] peak {peak:.2f} GiB allocated over the run (parameters, m and v, the "
        f"float32 gradient sums, a microbatch's gradients and activations)")
    for h in hist:
        if not (np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])):
            raise AssertionError(f"[train] step {h['step']}: loss {h['loss']} grad_norm "
                                 f"{h['grad_norm']} not finite")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"[train] the loss did not fall: {hist[0]['loss']} -> "
                             f"{hist[-1]['loss']}")

    # One more step, as train_loop runs it (batch upload, step, one metrics
    # read), profiled: host syncs and where the device time goes.
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, OptimizerConfig(total_steps=TRAIN_STEPS), microbatches=mb)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=l, global_batch=b, seed=seed)

    def one_step():
        _, _, metrics = step_fn(params, opt_state, to_device(data.batch_at(TRAIN_STEPS), device))
        return torch.stack(list(metrics.values())).tolist()

    sites = []
    profile_request(f"train step {b}x{l}", one_step, sites)
    log(f"[train] the profiled step's host syncs, by file:line: {sites}")

    # The roofline analysis of the same step, against the run and against
    # one more step counted on the card.
    pred = prediction.result(ROOFLINE_LIMIT_S)
    log(roofline_line(f"[train] step {b}x{l} in {mb} microbatches", pred))
    c = counted_step(step_fn, params, opt_state,
                     to_device(data.batch_at(TRAIN_STEPS + 1), device))
    step_s = float(np.median([h["step_time"] for h in hist[1:]]))
    largest = max(pred["compute_s"], pred["memory_s"], pred["collective_s"])
    ratio = check_peak("[train]", pred["peak_memory_in_bytes"], c["peak"])
    log(f"[roofline] [train] measured: step {step_s:.4f} s (median of steps 1-"
        f"{len(hist) - 1}) = {step_s / largest:.3f} x the largest term ({pred['dominant']}, "
        f"{largest:.6f} s); one step's peak {c['peak'] / 2**30:.3f} GiB allocated (the "
        f"counter's tally of live tensors on the card {c['tally'] / 2**30:.3f} GiB; "
        f"train_loop's run {peak_bytes / 2**30:.3f} GiB), predicted / measured {ratio:.4f} "
        f"(bound {ROOFLINE_PEAK_BOUND}); {ident}")
    del params, opt_state, step_fn

    # int8 gradient compression with error feedback.
    torch.cuda.empty_cache()
    comp = train_loop(cfg, steps=TRAIN_COMPRESSED_STEPS, compress_grads=True, **kw)[1]
    for h in comp:
        if not (np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])):
            raise AssertionError(f"[train] compressed step {h['step']} not finite: {h}")
    log(f"[train] compress_grads: {len(comp)} steps, losses "
        f"{[round(h['loss'], 6) for h in comp]}, grad_norms "
        f"{[round(h['grad_norm'], 6) for h in comp]}, step times "
        f"{[round(h['step_time'], 4) for h in comp]} s, all finite")

    # Remat on the card: the peak of lm_loss and its backward pass for each
    # mode at a shape that fits without remat; then a float32 copy's
    # gradients, equal element for element across the three.
    rb, rl = REMAT_SHAPE
    rdata = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=rl, global_batch=rb, seed=seed)
    rbatch = to_device(rdata.batch_at(0), device)

    def grads(c, p):
        flat = flatten(p)
        loss, _ = lm_loss(p, c, rbatch)
        return loss.detach(), torch.autograd.grad(loss, list(flat.values()))

    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    for t in flatten(params).values():
        t.requires_grad_(True)
    resident = torch.cuda.memory_allocated() / 2**30
    peaks = {}
    for remat in ("none", "dots", "full"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = grads(dataclasses.replace(cfg, remat=remat), params)
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated() / 2**30, time.perf_counter() - t0)
        del out
    log(f"[train] remat at {rb}x{rl}, all {cfg.n_layers} layers, bf16: peak GiB allocated "
        "over lm_loss and its backward pass (parameters resident: "
        f"{resident:.2f}), seconds: " + ", ".join(
            f"{k} {v[0]:.2f} GiB {v[1]:.4f} s" for k, v in peaks.items()) + f"; {ident}")
    if not max(peaks["dots"][0], peaks["full"][0]) < peaks["none"][0]:
        raise AssertionError(f"[train] remat saved no memory: {peaks}")
    del params
    torch.cuda.empty_cache()
    c32 = dataclasses.replace(cfg, dtype="float32", n_layers=REMAT_CHECK_LAYERS)
    params = init_params(c32, torch.Generator(device=device).manual_seed(seed))
    for t in flatten(params).values():
        t.requires_grad_(True)
    loss0, g0 = grads(dataclasses.replace(c32, remat="none"), params)
    for remat in ("dots", "full"):
        loss, g = grads(dataclasses.replace(c32, remat=remat), params)
        diff = max(float((a - b_).abs().max()) for a, b_ in zip(g, g0))
        if not (torch.equal(loss, loss0) and all(torch.equal(a, b_) for a, b_ in zip(g, g0))):
            raise AssertionError(f"[train] float32 remat {remat!r}: gradients differ from "
                                 f"'none' by up to {diff:.3g}")
    log(f"[train] float32 copy ({REMAT_CHECK_LAYERS} of {cfg.n_layers} layers, {rb}x{rl}): "
        f"loss and all {len(g0)} gradient leaves of 'dots' and 'full' equal to 'none' "
        "element for element")
    del params, g0, g, loss0, loss

    # The restart drill: DRILL_LAYERS of the layers at full width; a run that
    # fails at step DRILL_FAIL restarts from its step-DRILL_EVERY checkpoint
    # and ends with the uninterrupted run's loss.
    torch.cuda.empty_cache()
    dcfg = dataclasses.replace(cfg, n_layers=DRILL_LAYERS)
    t0 = time.perf_counter()
    full = train_loop(dcfg, steps=DRILL_STEPS, **kw)[1]
    with tempfile.TemporaryDirectory() as d:
        try:
            train_loop(dcfg, steps=DRILL_STEPS, ckpt_dir=d, ckpt_every=DRILL_EVERY,
                       fail_at_step=DRILL_FAIL, **kw)
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        else:
            raise AssertionError("[train] the drill's injected failure did not fire")
        committed = checkpoint.latest_step(d)
        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(d) for f in fs)
        if committed != DRILL_EVERY or any(f.endswith(".tmp") for f in os.listdir(d)):
            raise AssertionError(f"[train] drill: committed {committed}, {os.listdir(d)}")
        _, resumed = train_loop(dcfg, steps=DRILL_STEPS, ckpt_dir=d, ckpt_every=DRILL_EVERY,
                                **kw)
    got, want = resumed[-1]["loss"], full[-1]["loss"]
    if resumed[0]["step"] != DRILL_EVERY or not abs(got - want) <= 1e-5 * abs(want):
        raise AssertionError(f"[train] drill: resumed at {resumed[0]['step']}, last loss "
                             f"{got!r} against the uninterrupted run's {want!r}")
    log(f"[train] restart drill ({DRILL_LAYERS} of {cfg.n_layers} layers, full width): failed "
        f"at step {DRILL_FAIL}, step {committed} committed ({ckpt_bytes / 1e9:.2f} GB), resumed "
        f"from it; last loss {got!r} against the uninterrupted {want!r} "
        f"({'bit-equal' if got == want else f'relative difference {abs(got - want) / abs(want):.3g}'}"
        f", limit 1e-5); {time.perf_counter() - t0:.1f} s")
    log(f"[train] the phase took {time.perf_counter() - t_phase:.1f} s; {ident}")


SHARDED_ARCH = "qwen3_moe_30b_a3b"  # [sharded]: moe_impl "shard_map", moe_shard "expert"
SHARDED_LAYERS = 2              # layers a rank: 2 on one card, 8 on four
SHARDED_SEQ = 4096              # the train_4k shape's sequence length
SHARDED_STEPS = 3               # of 2 * dp x 4,096 tokens
SHARDED_MICROBATCHES = 2
SHARDED_CHECK = (2, 512)        # the float32 parity forward: batch x tokens
SHARDED_CHECK_ARCHS = ("qwen3_moe_30b_a3b", "grok_1_314b")   # "expert", "tensor"
SHARDED_CHECK_LAYERS = 2
SHARDED_TOL = 2e-4              # repro's tolerance between the two MoE engines
SHARDED_DRILL = (1, 512, 2)     # the elastic drill: layers, tokens a row, steps saved
SHARDED_DRILL_TOL = 1e-5        # the resumed step's loss against the restored parameters'
SHARDED_LIMIT_S = 900           # the parent's wait for a spawned rank


def sharded_world() -> int:
    """Ranks of the [sharded] phase: one a card, up to 4 (2 on 2 or 3)."""
    import torch

    n = torch.cuda.device_count()
    return 4 if n >= 4 else 2 if n >= 2 else 1


def sharded_shape(world: int) -> tuple[int, int]:
    """The ``("data", "model")`` mesh of ``world`` ranks."""
    return {1: (1, 1), 2: (1, 2), 4: (2, 2)}[world]


def profile_step(fn) -> dict:
    """Run ``fn`` once under the profiler: wall and device busy ms, NCCL
    kernels on the device and NCCL calls on the host, the top 8 device
    activities (name, ms, count)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return {"wall_ms": wall, "busy_ms": sum(e.self_device_time_total for e in dev) / 1e3,
            "nccl_kernels": sum(e.count for e in dev if "nccl" in e.key.lower()),
            "nccl_calls": sum(e.count for e in events if e.device_type != DeviceType.CUDA
                              and e.key.startswith("nccl:")),
            "top": [(e.key[:80], e.self_device_time_total / 1e3, e.count) for e in top]}


def sharded_job(rank: int, world: int, seed: int, tmp: str) -> dict:
    """One rank's share of ``[sharded]``, on the mesh of all ``world`` ranks:
    ``train_loop(mesh=...)`` at full width, a profiled step, the float32
    parity of the two MoE engines, the elastic drill.  Returns numbers."""
    import dataclasses

    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.mesh import dp_axes, make_mesh
    from repro_torch.launch.train import to_device, train_loop
    from repro_torch.models import forward, init_params, lm_loss
    from repro_torch.models.layers import ShapesOnly
    from repro_torch.models.sharding import (
        P,
        make_activation_policy,
        placements,
        shard_params,
        use_policy,
    )
    from repro_torch.train import checkpoint
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.step import make_train_step
    from repro_torch.train.tree import flatten, placed_like, tree_map, whole

    device = "cuda"
    shape = sharded_shape(world)
    mesh = make_mesh(shape, ("data", "model"), device=device)
    dp = shape[0]
    out: dict = {"rank": rank, "mesh": shape}

    # train_loop on the mesh: the run a user starts.
    cfg = dataclasses.replace(get_config(SHARDED_ARCH), n_layers=SHARDED_LAYERS * world,
                              moe_impl="shard_map")
    b, l, mb = 2 * dp, SHARDED_SEQ, SHARDED_MICROBATCHES
    kw = dict(global_batch=b, seq_len=l, microbatches=mb, seed=seed, device=device,
              log_every=10**9)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, hist = train_loop(cfg, steps=SHARDED_STEPS, mesh=mesh, **kw)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    out["hist"] = [{k: h[k] for k in ("step", "step_time", "loss", "grad_norm", "lr")}
                   for h in hist]
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    flat = flatten(params)
    out["n_params"] = sum(t.numel() for t in flat.values())
    out["local_gb"] = sum(t.to_local().numel() * t.element_size() for t in flat.values()) / 1e9
    out["cfg"] = (cfg.name, cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.d_ff,
                  cfg.vocab_size, cfg.dtype, cfg.remat)

    # One more step as train_loop runs it, profiled: NCCL calls and kernels.
    policy = make_activation_policy(mesh, cfg, dp=dp_axes(mesh))
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, OptimizerConfig(total_steps=SHARDED_STEPS), microbatches=mb)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=l, global_batch=b, seed=seed)

    def one_step():
        with use_policy(policy):
            _, _, m = step_fn(params, opt_state, to_device(data.batch_at(SHARDED_STEPS),
                                                           device, mesh))
            return torch.stack([whole(v).float() for v in m.values()]).tolist()

    out["profile"] = profile_step(one_step)

    # One more step on every rank under the roofline analysis' own counter
    # on the real group: collective calls by kind, and the peak.
    out["counted"] = counted_step(step_fn, params, opt_state,
                                  to_device(data.batch_at(SHARDED_STEPS + 1), device, mesh),
                                  policy)
    del params, opt_state, step_fn, flat
    torch.cuda.empty_cache()

    # Float32 copies, dropless (capacity_factor E/k): shard_map against gspmd.
    out["parity"] = {}
    for arch in SHARDED_CHECK_ARCHS:
        base = get_config(arch)
        c32 = dataclasses.replace(base, dtype="float32", n_layers=SHARDED_CHECK_LAYERS,
                                  capacity_factor=base.n_experts / base.experts_per_token,
                                  remat="none")
        t0 = time.perf_counter()
        p32 = init_params(c32, torch.Generator(device=device).manual_seed(seed))
        p32 = shard_params(p32, c32, mesh)
        toks = torch.randint(0, c32.vocab_size, SHARDED_CHECK, device=device,
                             generator=torch.Generator(device=device).manual_seed(seed + 1))
        toks = distribute_tensor(toks, mesh, placements(P(dp_axes(mesh), None), mesh),
                                 src_data_rank=None)
        pol = make_activation_policy(mesh, c32, dp=dp_axes(mesh))
        logits, secs = {}, {}
        for impl in ("shard_map", "gspmd"):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with use_policy(pol), torch.no_grad():
                lg, _ = forward(p32, dataclasses.replace(c32, moe_impl=impl), toks)
                logits[impl] = whole(lg)
            torch.cuda.synchronize()
            secs[impl] = time.perf_counter() - t1
        err = float((logits["shard_map"] - logits["gspmd"]).abs().max())
        out["parity"][arch] = {"err": err, "scale": float(logits["gspmd"].abs().max()),
                               "moe_shard": c32.moe_shard, "s": secs,
                               "total_s": time.perf_counter() - t0}
        del logits, lg
        if arch == SHARDED_ARCH:
            # Remat changes no number: the float32 gradients of lm_loss on
            # the mesh, remat "none" against "full" (shard_map MoE).
            rdata = SyntheticLMData(vocab_size=c32.vocab_size, seq_len=SHARDED_CHECK[1],
                                    global_batch=SHARDED_CHECK[0], seed=seed)
            rbatch = to_device(rdata.batch_at(0), device, mesh)
            flat = flatten(p32)
            for t in flat.values():
                t.requires_grad_(True)
            grads = {}
            for remat in ("none", "full"):
                with use_policy(pol):
                    loss, _ = lm_loss(p32, dataclasses.replace(c32, remat=remat), rbatch)
                    g = torch.autograd.grad(loss, list(flat.values()))
                grads[remat] = [whole(placed_like(x, flat[k])) for k, x in zip(flat, g)]
                del loss, g
            out["parity"][arch]["remat_err"] = max(
                float((a - b).abs().max()) for a, b in zip(grads["none"], grads["full"]))
            out["parity"][arch]["n_grads"] = len(flat)
            del grads, flat, rbatch
        del p32
        torch.cuda.empty_cache()

    # The elastic drill: the mesh's run checkpointed at step saved_at, then
    # resumed by the first half of the ranks on a smaller mesh (one card: no
    # mesh) through train_loop, which restores the parameters, m and v there
    # and runs one more step.
    layers, dl, saved_at = SHARDED_DRILL
    dcfg = dataclasses.replace(get_config(SHARDED_ARCH), n_layers=layers, moe_impl="shard_map")
    ckpt_dir = os.path.join(tmp, "drill")
    dkw = dict(global_batch=2 * dp, seq_len=dl, seed=seed, device=device, log_every=10**9,
               ckpt_dir=ckpt_dir, ckpt_every=10**9)
    t0 = time.perf_counter()
    p1, _ = train_loop(dcfg, steps=saved_at, mesh=mesh, **dkw)
    drill: dict = {"write_s": time.perf_counter() - t0}
    saved = {k: whole(v) for k, v in flatten(p1).items()}
    del p1
    small = None
    if world > 1:
        small = DeviceMesh(device, torch.arange(world // 2).reshape(1, world // 2),
                           mesh_dim_names=("data", "model"))
    drill["small"] = None if small is None else tuple(small.shape)
    if rank < max(world // 2, 1):
        t0 = time.perf_counter()
        params = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device),
                          init_params(dcfg, ShapesOnly()))
        if small is not None:
            params = shard_params(params, dcfg, small)
        restored, extra = checkpoint.restore(ckpt_dir, checkpoint.latest_step(ckpt_dir),
                                             {"params": params})
        drill["equal"] = all(torch.equal(whole(v), saved[k])
                             for k, v in flatten(restored["params"]).items())
        drill["saved_step"] = extra["step"]
        drill["restore_s"] = time.perf_counter() - t0
        drill["ckpt_gb"] = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs
                               in os.walk(os.path.join(ckpt_dir, f"step_{saved_at}"))
                               for f in fs) / 1e9
        # The loss that the resumed step must see: the restored parameters'
        # on its batch, on the same mesh.
        ddata = SyntheticLMData(vocab_size=dcfg.vocab_size, seq_len=dl, global_batch=2 * dp,
                                seed=seed)
        spol = None if small is None else make_activation_policy(small, dcfg,
                                                                 dp=dp_axes(small))
        with use_policy(spol), torch.no_grad():
            loss, _ = lm_loss(restored["params"], dcfg,
                              to_device(ddata.batch_at(saved_at), device, small))
            drill["want_loss"] = float(whole(loss))
        del params, restored, loss
        t0 = time.perf_counter()
        _, resumed = train_loop(dcfg, steps=saved_at + 1, mesh=small, **dkw)
        drill["resume_s"] = time.perf_counter() - t0
        drill["resumed"] = [{k: h[k] for k in ("step", "loss", "grad_norm")} for h in resumed]
    out["drill"] = drill
    del saved
    torch.cuda.empty_cache()
    return out


def sharded_rank(rank, world, rendezvous, results, seed, tmp) -> None:
    """A spawned rank of ``[sharded]``: joins the NCCL group on its card,
    runs :func:`sharded_job` and sends its numbers back."""
    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("nccl", init_method=f"file://{rendezvous}", rank=rank,
                                world_size=world, device_id=torch.device("cuda", rank))
        try:
            out = sharded_job(rank, world, seed, tmp)
        finally:
            dist.destroy_process_group()
        results.put((rank, "ok", out))
    except BaseException:
        import traceback

        results.put((rank, "error", traceback.format_exc()))


def sharded_phase(seed, ledger) -> None:
    """``[sharded]``: the sharded model stack on a ``DeviceMesh`` of one rank
    a card (a group of one in this process on one card, ``(1, 1)``; one
    spawned process a card on four, ``(2, 2)``): Qwen3-30B-A3B at full
    width (``moe_impl="shard_map"``, experts on ``model``), 2 layers a rank,
    through ``train_loop(mesh=...)``; a profiled step; float32 copies of it
    and of Grok-1 (``moe_shard="tensor"``) whose ``shard_map`` and ``gspmd``
    MoE logits agree within 2e-4; the elastic drill.  The path launches no
    kernel of the port."""
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    ident = card_identity()
    world = sharded_world()
    prediction = roofline_prediction("sharded", world)
    ledger.start()
    with tempfile.TemporaryDirectory() as tmp:
        rendezvous = os.path.join(tmp, "rendezvous")
        if world == 1:
            dist.init_process_group("nccl", init_method=f"file://{rendezvous}", rank=0,
                                    world_size=1, device_id=torch.device("cuda", 0))
            try:
                outs = [sharded_job(0, 1, seed, tmp)]
            finally:
                dist.destroy_process_group()
        else:
            ctx = mp.get_context("spawn")
            results = ctx.Queue()
            procs = [ctx.Process(target=sharded_rank,
                                 args=(r, world, rendezvous, results, seed, tmp))
                     for r in range(world)]
            for p in procs:
                p.start()
            try:
                got = {}
                for _ in range(world):
                    rank, status, payload = results.get(timeout=SHARDED_LIMIT_S)
                    if status != "ok":
                        raise AssertionError(f"[sharded] rank {rank} failed:\n{payload}")
                    got[rank] = payload
                for p in procs:
                    p.join(timeout=60)
            finally:
                for p in procs:
                    if p.is_alive():
                        p.kill()
                        p.join()
            outs = [got[r] for r in range(world)]
    ledger.end("sharded (plain PyTorch on a DeviceMesh, as in repro)", ())

    o = outs[0]
    name, n_layers, d, e, f, vocab, dtype, remat = o["cfg"]
    b, l = 2 * o["mesh"][0], SHARDED_SEQ
    log(f"[sharded] {name} on a {o['mesh']} ('data', 'model') mesh of {world} card(s): "
        f"{n_layers} layers ({SHARDED_LAYERS} a rank), d {d}, {e} experts of d_ff {f}, "
        f"vocab {vocab}, {dtype}, remat {remat!r}, moe_impl 'shard_map': {o['n_params']} "
        f"parameters; {b} x {l} tokens a step in {SHARDED_MICROBATCHES} microbatches; {ident}")
    for h0 in o["hist"]:
        losses = {(round(x["hist"][h0["step"]]["loss"], 6)) for x in outs}
        log(f"[sharded] step {h0['step']}: "
            f"{max(x['hist'][h0['step']]['step_time'] for x in outs):.4f} s (slowest rank), "
            f"{b * l / max(x['hist'][h0['step']]['step_time'] for x in outs):.1f} tokens/s, "
            f"loss {h0['loss']:.6f}, grad_norm {h0['grad_norm']:.6f}, lr {h0['lr']:.6g}; "
            f"{ident}")
        if len(losses) != 1:
            raise AssertionError(f"[sharded] step {h0['step']}: ranks disagree on the loss "
                                 f"{losses}")
    for x in outs:
        for h in x["hist"]:
            if not (np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])):
                raise AssertionError(f"[sharded] rank {x['rank']} step {h['step']}: not "
                                     f"finite {h}")
        log(f"[sharded] rank {x['rank']}: peak {x['peak_gib']:.2f} GiB allocated over "
            f"train_loop, its shards {x['local_gb']:.2f} GB of parameters; train_loop "
            f"{x['train_s']:.1f} s")
    for x in outs:
        p = x["profile"]
        log(f"[profile] sharded train step, rank {x['rank']}: wall {p['wall_ms']:.3f} ms, "
            f"device busy {p['busy_ms']:.3f} ms ({p['busy_ms'] / p['wall_ms']:.1%}), NCCL "
            f"kernels {p['nccl_kernels']}, NCCL calls {p['nccl_calls']}")
        if x["rank"] == 0:
            for key, ms, count in p["top"]:
                log(f"[profile]   {ms:9.3f} ms x{count:<5d} {key}")
    if world > 1 and not all(x["profile"]["nccl_kernels"] > 0 for x in outs):
        raise AssertionError("[sharded] a rank's profiled step ran no NCCL kernel")

    # The roofline analysis of the same step on a fake group of as many
    # ranks, against the step counted on the real one.
    pred = prediction.result(ROOFLINE_LIMIT_S)
    log(roofline_line(f"[sharded] step {b}x{l} in {SHARDED_MICROBATCHES} microbatches, rank 0 "
                      f"of {o['mesh']}", pred))
    for x in outs:
        c = x["counted"]
        ratio = check_peak(f"[sharded] rank {x['rank']}", pred["peak_memory_in_bytes"],
                           c["peak"])
        counted = {k: int(v) for k, v in c["bytes"].items()}
        log(f"[roofline] [sharded] rank {x['rank']} counted on the card: collective calls "
            f"{c['calls']}, bytes {counted}; step {c['step_s']:.4f} s under the counter; peak {c['peak'] / 2**30:.3f} GiB "
            f"(held before the step {c['held'] / 2**30:.3f} GiB, of it the step's arguments "
            f"{c['args'] / 2**30:.3f} GiB; the counter's tally {c['tally'] / 2**30:.3f} GiB), "
            f"predicted / measured {ratio:.4f} (bound {ROOFLINE_PEAK_BOUND}); {ident}")
        if c["calls"] != pred["collective_calls_per_dev"]:
            raise AssertionError(f"[roofline] [sharded] rank {x['rank']}: collective calls "
                                 f"{c['calls']} on the card, {pred['collective_calls_per_dev']}"
                                 " predicted")
    for arch in SHARDED_CHECK_ARCHS:
        pa = o["parity"][arch]
        err = max(x["parity"][arch]["err"] for x in outs)
        log(f"[sharded] float32 {arch} ({SHARDED_CHECK_LAYERS} layers, moe_shard "
            f"{pa['moe_shard']!r}, dropless), forward over {SHARDED_CHECK[0]} x "
            f"{SHARDED_CHECK[1]}: shard_map against gspmd logits max abs err {err:.3g} "
            f"(max |logit| {pa['scale']:.3g}, limit {SHARDED_TOL}); shard_map "
            f"{pa['s']['shard_map']:.3f} s, gspmd {pa['s']['gspmd']:.3f} s; "
            f"{pa['total_s']:.1f} s with the init")
        if not err <= SHARDED_TOL:
            raise AssertionError(f"[sharded] {arch}: shard_map and gspmd differ by {err}")
        if "remat_err" in pa:
            rerr = max(x["parity"][arch]["remat_err"] for x in outs)
            log(f"[sharded] float32 {arch}: all {pa['n_grads']} gradient leaves of lm_loss "
                f"on the mesh, remat 'full' against 'none': max abs difference {rerr:.3g} "
                f"(limit {SHARDED_TOL})")
            if not rerr <= SHARDED_TOL:
                raise AssertionError(f"[sharded] {arch}: remat moves the gradients by {rerr}")
    saved_at = SHARDED_DRILL[2]
    drills = [x["drill"] for x in outs if "equal" in x["drill"]]
    for dr in drills:
        (h,) = dr["resumed"]
        rel = abs(h["loss"] - dr["want_loss"]) / abs(dr["want_loss"])
        if not (dr["equal"] and dr["saved_step"] == saved_at and h["step"] == saved_at
                and rel <= SHARDED_DRILL_TOL and np.isfinite(h["grad_norm"])):
            raise AssertionError(f"[sharded] elastic drill: {dr}")
    dr = drills[0]
    (h,) = dr["resumed"]
    log(f"[sharded] elastic drill ({SHARDED_DRILL[0]} layers, full width): step {saved_at} "
        f"saved from the {o['mesh']} mesh ({dr['ckpt_gb']:.2f} GB) in "
        f"{max(x['drill']['write_s'] for x in outs):.1f} s ({saved_at} steps included); on "
        f"{dr['small'] or 'one card without a mesh'}, {len(drills)} rank(s): the parameters "
        f"restored bit-equal to the saved ones in {dr['restore_s']:.1f} s, then train_loop "
        f"restored parameters, m and v and resumed at step {h['step']} in "
        f"{dr['resume_s']:.1f} s (its checkpoint written): loss {h['loss']!r} against "
        f"{dr['want_loss']!r} from the restored parameters (relative difference "
        f"{rel:.3g}, limit {SHARDED_DRILL_TOL}), grad_norm {h['grad_norm']:.6f}")
    log(f"[sharded] the phase took {time.perf_counter() - t_phase:.1f} s; {ident}")


PLAN_RUNS = 4                   # [plans]: runs of one cached plan
REDUCE_CASES = (                # [reduce]: (problem, backend, held against, passes,
    ("d1", "cuda_fused", "reference", 2, None),    # graph: None = the run's)
    ("d2", "cuda_fused", "cuda", 1, None),
    # cuda and cuda_fused share d2_assign and collision: hold those against
    # the plain versions too, on a graph where reference's pass is short.
    ("d2", "cuda_fused", "reference", 1, "hex:128,128,128"),
)
BACKEND_KERNELS = {             # the kernels each backend's requests launch
    ("d1", "cuda"): ("vb_bit_assign", "collision", "conflict_detect"),
    ("d1", "cuda_fused"): ("vb_bit_assign", "collision", "fused_round"),
    ("d2", "cuda"): ("d2_assign", "collision", "conflict_detect"),
    ("d2", "cuda_fused"): ("d2_assign", "collision", "fused_round"),
}


def fresh_caches(host_state: bool = False) -> None:
    """Empty the default plan cache (and with ``host_state`` the host-state
    cache) and give the device memory back: the next plan build is cold."""
    import torch

    from repro_torch.core import plan as plan_mod

    plan_mod.default_plan_cache().clear()
    if host_state:
        plan_mod._STATE_CACHE.clear()
    torch.cuda.empty_cache()


def plans_phase(pg, pg2, device, ledger) -> None:
    """``[plans]``: a keyed plan cache hit, the loop built once over warm
    runs, ``color_distributed`` twice through the default cache, each
    plan's pinned bytes beside the device memory it adds, and eviction by
    bytes."""
    import torch

    from repro_torch.core.distributed import color_distributed
    from repro_torch.core.plan import PlanCache, default_plan_cache, get_plan

    t_phase = time.perf_counter()
    # Only a cached plan or host state needs the key: no cold call above
    # has hashed either topology.
    hashed = [x.name for x in (pg, pg2) if "_signature" in vars(x)]
    if hashed:
        raise AssertionError(f"a cold call hashed the topology of {hashed}")
    _, sig_s = wall_s(lambda: pg.signature)
    _, sig2_s = wall_s(lambda: pg2.signature)
    log(f"[plans] the topology hash a plan key needs (pg.signature, memoized per "
        f"PartitionedGraph), alone: {sig_s:.4f} s for {pg.name}, {sig2_s:.4f} s with "
        f"the second ghost layer; no cold call before made it")
    fresh_caches(host_state=True)
    cache = PlanCache()
    ledger.start()
    plan, get_s = wall_s(lambda: get_plan(pg, backend="cuda_fused", device=device,
                                          cache=cache))
    again = get_plan(pg, backend="cuda_fused", device=device, cache=cache)
    if again is not plan or (cache.misses, cache.hits) != (1, 1):
        raise AssertionError("get_plan twice did not return one cached plan")
    runs = [ledger.timed(f"plans d1 cuda_fused run {i + 1}", plan.run)
            for i in range(PLAN_RUNS)]
    ledger.end("plans d1 cuda_fused", BACKEND_KERNELS["d1", "cuda_fused"])
    if plan.stats.traces != 1 or plan.stats.runs != PLAN_RUNS:
        raise AssertionError(f"plan stats after {PLAN_RUNS} runs: {plan.stats}")
    if not all(same_result(r, runs[0][0]) for r, _ in runs):
        raise AssertionError("the runs of one plan differ")
    log(f"[plans] d1 cuda_fused get_plan twice: one plan, misses 1, hits 1; built in "
        f"{get_s:.4f} s (build_ms {plan.stats.build_ms:.1f}); traces "
        f"{plan.stats.traces} after {PLAN_RUNS} runs of "
        f"{[round(s, 4) for _, s in runs]} s (compile_ms, the first run, "
        f"{plan.stats.compile_ms:.1f})")
    del plan, again, cache

    fresh_caches(host_state=True)
    default = default_plan_cache()
    counts = [(default.misses, default.hits)]
    ledger.start()
    first, first_s = ledger.timed("plans color_distributed 1 (builds its plan)",
                                  lambda: color_distributed(pg, backend="cuda_fused",
                                                            device=device))
    counts.append((default.misses, default.hits))
    second, second_s = ledger.timed("plans color_distributed 2 (a cache hit)",
                                    lambda: color_distributed(pg, backend="cuda_fused",
                                                              device=device))
    counts.append((default.misses, default.hits))
    ledger.end("plans color_distributed", BACKEND_KERNELS["d1", "cuda_fused"])
    [cached] = default.plans()
    if not (same_result(first, second) and same_result(first, runs[0][0])):
        raise AssertionError("color_distributed through the cache differs")
    # (misses, hits) of the default cache: a miss, then a hit.
    if [(m - counts[0][0], h - counts[0][1]) for m, h in counts] != [(0, 0), (1, 0), (1, 1)]:
        raise AssertionError(f"default cache (misses, hits) went {counts}")
    log(f"[plans] color_distributed twice through the default cache: {first_s:.4f} s "
        f"(a miss: built the plan in {cached.stats.build_ms / 1e3:.4f} s, host state "
        f"included), then {second_s:.4f} s (a hit)")
    del cached, first, second, runs

    fresh_caches()
    evicted = []

    def on_evict(key, plan):
        evicted.append(key)

    sized = PlanCache()
    sized.add_evict_listener(on_evict)
    held = {}
    for label, pgx, problem in (("d1", pg, "d1"), ("d2", pg2, "d2")):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        p = get_plan(pgx, problem=problem, backend="cuda_fused", device=device,
                     cache=sized)
        torch.cuda.synchronize()
        added = torch.cuda.memory_allocated() - before
        tensors = sum(v.numel() * v.element_size() for v in p._st.values())
        log(f"[plans] {label} cuda_fused plan: nbytes {p.nbytes} ({tensors} B of device "
            f"tensors, {p.nbytes - tensors} B of host tables); "
            f"torch.cuda.memory_allocated() grew {added} B")
        held[label] = p
        if label == "d1":
            sized.max_bytes = p.nbytes      # room for the d1 plan alone
    if sized.keys() != [held["d2"].key] or evicted != [held["d1"].key]:
        raise AssertionError("PlanCache(max_bytes=...) did not evict the d1 plan")
    log(f"[plans] PlanCache(max_bytes={sized.max_bytes}): the d2 plan evicted the d1 "
        f"plan; total_bytes {sized.total_bytes}")
    del held, p, sized
    fresh_caches()
    log(f"[plans] phase {time.perf_counter() - t_phase:.1f} s")


def reduce_phase(g, pg, pg2, device, ledger) -> None:
    """``[reduce]``: iterative color reduction on the kernel backends, every
    pass's coloring proper and never above the start, the result equal
    field by field to the same reduction on another backend."""
    import torch

    from repro_torch.core import validate
    from repro_torch.core.plan import PlanCache, get_plan
    from repro_torch.core.reduce import _cap_for, get_reduce_plan, reduce_colors
    from repro_torch.core.reduce import reduce_colors_batch
    from repro_torch.graph.partition import partition_graph
    from repro_torch.launch.color import make_graph

    fields = ("n_colors", "initial_n_colors", "improved", "passes_run",
              "colors_by_pass", "comm_bytes_by_pass", "rounds_by_pass",
              "exchanges_by_pass", "converged", "order", "problem")
    t_phase = time.perf_counter()
    for problem, backend, other, passes, spec in REDUCE_CASES:
        fresh_caches()
        if spec is None:
            gx, pgx = g, (pg if problem == "d1" else pg2)
        else:
            t0 = time.perf_counter()
            gx = make_graph(spec)
            pgx = partition_graph(gx, pg.n_parts, second_layer=problem != "d1")
            log(f"[reduce] {gx.name} over {pg.n_parts} parts, second layer "
                f"{problem != 'd1'}: made in {time.perf_counter() - t0:.1f} s")
        proper = getattr(validate, VALIDATORS[problem])
        cache = PlanCache()
        plan = get_plan(pgx, problem=problem, backend=backend, device=device, cache=cache)
        base = plan.run()
        by_pass = []
        # Each pass selects its classes once: a select opens the pass's row.
        rplan = get_reduce_plan(plan.n_global, _cap_for(int(base.colors.max())),
                                "reverse", cache=cache, device=device)
        select = rplan.select

        def select_opens_a_pass(colors):
            by_pass.append({"supersteps": 0, "s": 0.0, "launches": {}})
            return select(colors)

        rplan.select = select_opens_a_pass

        def run_many(reqs):
            row = by_pass[-1]
            before = ledger.read()
            out, s = wall_s(lambda: [plan.run(**r) for r in reqs])
            row["supersteps"] += len(reqs)
            row["s"] += s
            for k, v in ledger.read().items():
                if v != before[k]:
                    row["launches"][k] = row["launches"].get(k, 0) + v - before[k]
            row["colors"] = out[-1].colors      # the pass's coloring so far
            return out

        label = f"reduce {problem} {backend}" + ("" if spec is None else f" {gx.name}")
        ledger.start()
        [red], red_s = wall_s(lambda: reduce_colors_batch(
            plan, [base], passes=passes, order="reverse", cache=cache,
            run_many=run_many))
        ledger.end(label, BACKEND_KERNELS[problem, backend])
        rplan.select = select
        if len(by_pass) != red.passes_run:
            raise AssertionError(f"{label}: {len(by_pass)} selects for "
                                 f"{red.passes_run} passes")
        for i, row in enumerate(by_pass):
            n = validate.num_colors(row["colors"])
            if not proper(gx, row["colors"]) or n > base.n_colors:
                raise AssertionError(f"{label} pass {i + 1}: {n} colors, proper "
                                     f"{proper(gx, row['colors'])}")
            log(f"[reduce] {label} pass {i + 1}: {n} colors, {row['supersteps']} "
                f"supersteps, {row['s']:.4f} s, launches {row['launches']}")
        if not (proper(gx, red.colors) and red.converged
                and red.n_colors <= base.n_colors):
            raise AssertionError(f"{label}: the reduced coloring is not proper")

        oplan = get_plan(pgx, problem=problem, backend=other, device=device, cache=cache)
        if other != "reference":
            ledger.start()
        want, other_s = wall_s(lambda: reduce_colors(oplan, base, passes=passes,
                                                     order="reverse", cache=cache))
        if other != "reference":
            ledger.end(f"{label} against {other}", BACKEND_KERNELS[problem, other])
        if not (np.array_equal(red.colors, want.colors)
                and all(getattr(red, f) == getattr(want, f) for f in fields)):
            raise AssertionError(f"{label}: differs from the {other} backend")
        log(f"[reduce] {label} passes={passes} reverse: colors_by_pass "
            f"{red.colors_by_pass}, comm_bytes_by_pass {red.comm_bytes_by_pass}, "
            f"rounds_by_pass {red.rounds_by_pass}, exchanges_by_pass "
            f"{red.exchanges_by_pass}, {red_s:.4f} s; every pass proper "
            f"({VALIDATORS[problem]}) and at most {base.n_colors} colors; equal field "
            f"by field to the {other} backend on the card ({other_s:.4f} s)")
        del plan, oplan, rplan, cache, base, red, want, by_pass, gx, pgx
        torch.cuda.synchronize()
    fresh_caches()
    log(f"[reduce] phase {time.perf_counter() - t_phase:.1f} s")


def baseline_phase(g, pg, device) -> None:
    """``[baseline]``: the Zoltan-style batched-boundary baseline and
    Jones-Plassmann on d1, each proper."""
    from repro_torch.core.baseline import color_baseline
    from repro_torch.core.jones_plassmann import color_jones_plassmann
    from repro_torch.core.validate import is_proper_d1

    t_phase = time.perf_counter()
    for label, fn in (("color_baseline", color_baseline),
                      ("color_jones_plassmann", color_jones_plassmann)):
        res, s = wall_s(lambda: fn(pg, device=device))
        ok = res.converged and is_proper_d1(g, res.colors)
        log(f"[baseline] {label} d1 {g.name} over {pg.n_parts} parts: "
            f"rounds={res.rounds} colors={res.n_colors} "
            f"conflicts={res.total_conflicts} {s:.4f} s proper={ok}")
        if not ok:
            raise AssertionError(f"{label}: the coloring is not proper")
    fresh_caches()              # the host tables stay for [service]
    log(f"[baseline] phase {time.perf_counter() - t_phase:.1f} s")


SERVICE_BATCH = 12              # [service]: d1 warm requests, through max_batch 8
SERVICE_MAX_BATCH = 8
SERVICE_D2_BATCH = 4            # d2 warm requests
SERVICE_STREAM = 8              # frontend stream, alternating two topologies
SERVICE_STREAM_GRAPH = "hex:128,128,128"
SERVICE_NUMBERS: dict[str, str] = {}    # [service]'s, printed beside [shard_map]'s


def counting_steps(plan) -> dict:
    """Count the plan's slot-engine steps and the slot transitions in them
    (the live slots a step runs), and time every step (an instance
    attribute over the plan's own, read when a bucket's step is built).  A
    step starts after the last host sync and ends with its own, so its wall
    time holds its device work; each bucket's first step, which the
    service books in ``cold_ms`` and not in ``warm_ms_mean``, is timed as
    well."""
    counts = {"steps": 0, "transitions": 0, "step_s": 0.0}
    make = plan.slot_step

    def slot_step():
        step = make()

        def counted(carry):
            counts["steps"] += 1
            counts["transitions"] += int(carry["live"].sum())
            t0 = time.perf_counter()
            try:
                return step(carry)
            finally:
                counts["step_s"] += time.perf_counter() - t0

        return counted

    plan.slot_step = slot_step
    return counts


def carry_bytes(plan, bucket) -> tuple[int, int]:
    """An idle ``bucket``-slot carry of ``plan``: its device bytes, and how
    much ``torch.cuda.memory_allocated()`` grew to hold it."""
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    carry = plan.slot_carry(bucket, plan.slot_ex_init())
    torch.cuda.synchronize()
    grew = torch.cuda.memory_allocated() - before
    nbytes = sum(x.numel() * x.element_size() for x in leaves(carry)
                 if isinstance(x, torch.Tensor))
    return nbytes, grew


def warm_requests(plan, cold, n, rng):
    """``n`` warm requests: a random 10% ``color_mask`` each and ``colors0``
    the cold coloring with the masked vertices cleared."""
    from repro_torch.serve import ColoringRequest

    reqs = []
    for _ in range(n):
        m = rng.random(plan.n_global) < 0.1
        reqs.append(ColoringRequest(color_mask=m, colors0=np.where(m, 0, cold.colors)))
    return reqs


def service_batch(label, svc, reqs, ledger, uses) -> None:
    """``svc.run_batch(reqs)`` against the solo runs of the same requests:
    equal in every field; wall time, requests per second, stats, steps,
    launches, host syncs per step and memory."""
    import torch

    plan = svc.plan
    solo = []
    for r in reqs:
        solo.append(wall_s(lambda: plan.run(**r.plan_inputs())))
    solo_s = sum(s for _, s in solo)
    counts = counting_steps(plan)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ledger.start()
    t0 = time.perf_counter()
    got, syncs = count_syncs(lambda: svc.run_batch(reqs))
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    ledger.end(label, uses)
    peak = torch.cuda.max_memory_allocated() - before
    for i, (r, (want, _)) in enumerate(zip(got, solo, strict=True)):
        if not same_result(r, want):
            raise AssertionError(f"{label} request {i}: differs from its solo plan.run")
    s = svc.stats
    bucket = max(svc.buckets)
    nbytes, grew = carry_bytes(plan, bucket)
    log(f"[service] {label}: {len(reqs)} warm 10% requests equal to their solo plan.run "
        f"in every field; batch {batch_s:.4f} s ({len(reqs) / batch_s:.2f} req/s) against "
        f"solo {solo_s:.4f} s summed ({len(reqs) / solo_s:.2f} req/s)")
    SERVICE_NUMBERS[label] = (
        f"batch {batch_s:.4f} s ({len(reqs) / batch_s:.2f} req/s), solo {solo_s:.4f} s, "
        f"{syncs / max(counts['steps'], 1):.1f} syncs a step")
    log(f"[service] {label}: stats batches={s.batches} refills={s.refills} "
        f"cold_runs={s.cold_runs} cold_ms={s.cold_ms:.1f} "
        f"warm_ms_mean={s.warm_ms_mean:.1f}; {counts['steps']} steps, "
        f"{counts['transitions']} slot transitions, {syncs} host syncs "
        f"({syncs / max(counts['steps'], 1):.1f} a step, under count_syncs), launches "
        f"{ {k: v for k, v in ledger.paths[label].items() if v} }")
    log(f"[service] {label}: a {bucket}-slot carry (the batch's bucket) holds {nbytes} B "
        f"({nbytes / 1e9:.3f} GB; memory_allocated grew {grew} B to hold it); the "
        f"batch's peak memory_allocated grew {peak} B over the plan's")
    # A request's host work outside the steps: its inputs (numpy over every
    # vertex), their upload, and the result's download and gather.
    inputs, in_s = wall_s(lambda: plan.request_inputs(**reqs[0].plan_inputs()))
    args, up_s = wall_s(lambda: plan.slot_args(*inputs[:3]))
    nbytes_hist = torch.zeros((plan.max_rounds + 1, 2), dtype=torch.int32,
                              device=plan.device)
    _, out_s = wall_s(lambda: plan._result(args[0], 0, 0, 0, nbytes_hist))
    log(f"[service] {label}: one request's host work outside the steps: request_inputs "
        f"{in_s:.4f} s, slot_args upload {up_s:.4f} s, _result {out_s:.4f} s; the steps "
        f"took {counts['step_s']:.4f} s in all, {counts['step_s'] * 1e3 / len(reqs):.1f} ms "
        f"a request (every step timed; warm_ms_mean {s.warm_ms_mean:.1f} ms leaves out "
        "each bucket's first step)")


def service_phase(pg, pg2, device, ledger, seed) -> None:
    """``[service]``: the continuous-batching service on the card — a d1
    ``cuda_fused`` batch of warm requests through refills, a frontend
    stream over two topologies with ``sparse_delta`` (``pair_scatter``) and
    a reduction pass, and a d2 batch — each result equal to its solo run."""
    from repro_torch.core.plan import PlanCache, get_plan
    from repro_torch.core.reduce import reduce_colors
    from repro_torch.graph.partition import partition_graph
    from repro_torch.launch.color import make_graph
    from repro_torch.serve import ColoringFrontend, ColoringRequest, ColoringService

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed)
    fresh_caches()

    # 1. d1 cuda_fused, all_gather: one wave of 8, then refills.
    svc = ColoringService(pg, backend="cuda_fused", device=device, cache=PlanCache(),
                          max_batch=SERVICE_MAX_BATCH)
    cold, cold_s = wall_s(svc.plan.run)
    reqs = warm_requests(svc.plan, cold, SERVICE_BATCH, rng)
    log(f"[service] d1 cuda_fused plan's cold run {cold_s:.4f} s")
    service_batch("service d1 cuda_fused batch", svc, reqs, ledger,
                  BACKEND_KERNELS["d1", "cuda_fused"])
    del svc, cold, reqs
    fresh_caches()

    # 2. A frontend stream over two topologies, sparse_delta by name (plans
    # from the cache; the kernel backend makes it scatter with pair_scatter),
    # one reduction pass, replayed cold then warm.
    t0 = time.perf_counter()
    small = partition_graph(make_graph(SERVICE_STREAM_GRAPH), pg.n_parts)
    log(f"[service] {small.name}: made in {time.perf_counter() - t0:.1f} s")
    pg.__dict__.pop("_signature", None)         # the first admission hashes again
    fe = ColoringFrontend(backend="cuda_fused", exchange="sparse_delta", reduce_passes=1,
                          device=device, cache=PlanCache(), max_batch=SERVICE_MAX_BATCH)
    pgs = [pg, small]
    pairs = [(pgs[i % 2], ColoringRequest()) for i in range(SERVICE_STREAM)]
    ledger.start()
    t0 = time.perf_counter()
    sig_s, admit_s, tickets = {}, {}, []
    for pgx, req in pairs:
        if pgx.name in sig_s:
            tickets.append(fe.enqueue(pgx, req))
            continue
        _, sig_s[pgx.name] = wall_s(lambda: pgx.signature)
        ticket, admit_s[pgx.name] = wall_s(lambda: fe.enqueue(pgx, req))
        tickets.append(ticket)
    out = fe.drain(tickets)
    cold_results = [out[t] for t in tickets]
    cold_s = time.perf_counter() - t0
    warm_results, warm_s = wall_s(lambda: fe.run_stream(pairs))
    ledger.end("service frontend stream", BACKEND_KERNELS["d1", "cuda_fused"]
               + ("pair_scatter",))
    for pgx in pgs:
        plan = get_plan(pgx, cache=fe.cache, **fe._cfg)     # the frontend's plan
        if plan._strategy.scatter != "cuda":
            raise AssertionError("sparse_delta under cuda_fused must scatter with "
                                 "pair_scatter")
        base = plan.run()
        want = reduce_colors(plan, base, passes=1, cache=fe.cache).merged_result(base)
        for i, ((p, _), a, b) in enumerate(zip(pairs, cold_results, warm_results)):
            if p is pgx and not (same_result(a, want) and same_result(b, want)):
                raise AssertionError(f"service frontend stream request {i} ({pgx.name}) "
                                     "differs from its solo plan.run + reduce_colors")
    s = fe.stats
    log(f"[service] frontend stream of {SERVICE_STREAM} requests alternating "
        f"{pg.name} and {small.name} (d1 cuda_fused, sparse_delta scatter=cuda, "
        f"reduce_passes=1): every result equal to its solo plan.run + reduce_colors; "
        f"cold {cold_s:.4f} s ({SERVICE_STREAM / cold_s:.2f} req/s), warm {warm_s:.4f} s "
        f"({SERVICE_STREAM / warm_s:.2f} req/s); n_programs={fe.n_programs}")
    log(f"[service] frontend stream: pg.signature at first admission "
        f"{ {k: round(v, 4) for k, v in sig_s.items()} } s, the first admission after it "
        f"(plan build) {({k: round(v, 4) for k, v in admit_s.items()})} s; stats "
        f"batches={s.batches} refills={s.refills} cold_runs={s.cold_runs} "
        f"cold_ms={s.cold_ms:.1f} warm_ms_mean={s.warm_ms_mean:.1f}; launches "
        f"{ {k: v for k, v in ledger.paths['service frontend stream'].items() if v} }")
    SERVICE_NUMBERS["service frontend stream"] = (
        f"cold {cold_s:.4f} s ({SERVICE_STREAM / cold_s:.2f} req/s), warm {warm_s:.4f} s "
        f"({SERVICE_STREAM / warm_s:.2f} req/s)")
    fe.close()
    del fe, small, pgs, pairs, cold_results, warm_results, out, tickets, plan, base, want
    fresh_caches()

    # 3. d2 cuda_fused on the second-layer partition.
    svc = ColoringService(pg2, problem="d2", backend="cuda_fused", device=device,
                          cache=PlanCache(), max_batch=SERVICE_MAX_BATCH)
    cold, cold_s = wall_s(svc.plan.run)
    log(f"[service] d2 cuda_fused plan's cold run {cold_s:.4f} s")
    service_batch("service d2 cuda_fused batch", svc,
                  warm_requests(svc.plan, cold, SERVICE_D2_BATCH, rng), ledger,
                  BACKEND_KERNELS["d2", "cuda_fused"])
    del svc, cold
    fresh_caches(host_state=True)
    log(f"[service] phase {time.perf_counter() - t_phase:.1f} s")


# --------------------------------------------------------------------------
# [shard_map]: the multi-GPU engine, one process per card over NCCL.
# --------------------------------------------------------------------------

SHARD_MAP_CASES = (             # (problem, exchange, transport keywords)
    ("d1", "all_gather", None), ("d1", "halo", None), ("d1", "delta", None),
    ("d1", "sparse_delta", {"ragged": True}), ("d1", "sparse_delta", {"ragged": False}),
    ("d1", "hier_delta", {"ragged": False}), ("d1", "hier_delta", {"ragged": True}),
    ("d2", "sparse_delta", None),
)
SHARD_MAP_LIMIT_S = 600        # the parent's wait for a spawned group
SHARD_MAP_KERNELS = {"d1": ("vb_bit_assign", "collision", "fused_round"),
                     "d2": ("d2_assign", "collision", "fused_round")}
SHARD_MAP_SERVICE = ("service batch", "service stream")   # the service's paths


def shard_map_label(problem, name, kw) -> str:
    return f"{problem} {name}" + ("" if kw is None else f" ragged={kw['ragged']}")


def shard_map_exchange(name, kw):
    """The exchange of a case under ``cuda_fused``: a name, or an instance
    in one transport that scatters with ``pair_scatter`` as the name does."""
    from repro_torch.core.exchange import EXCHANGES

    return name if kw is None else EXCHANGES[name](scatter="cuda", **kw)


def profile_counts(requests) -> tuple:
    """Run each of ``requests`` once in one profiler session: (results,
    device busy ms, NCCL kernels on the device, NCCL calls on the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = [request() for request in requests]
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    nccl_dev = sum(e.count for e in dev if "nccl" in e.key.lower())
    nccl_host = sum(e.count for e in events
                    if e.device_type != DeviceType.CUDA and e.key.startswith("nccl:"))
    return out, busy, nccl_dev, nccl_host


def digest(res) -> str:
    """Every field of a ``ColoringResult`` (or a reduction's colors and
    trajectory) in one hash: the ranks send only this."""
    import hashlib

    h = hashlib.blake2b(np.ascontiguousarray(res.colors).tobytes(), digest_size=16)
    if hasattr(res, "colors_by_pass"):
        h.update(repr((res.colors_by_pass, res.comm_bytes_by_pass,
                       res.rounds_by_pass)).encode())
        return h.hexdigest()
    for v in (res.rounds, res.converged, res.total_conflicts, res.n_colors,
              res.comm_bytes_total, res.comm_bytes_per_round):
        h.update(repr(v).encode())
    for a in (res.comm_bytes_by_round, res.comm_bytes_by_level):
        # A reduction's merged result keeps no bytes by round or level.
        h.update(b"none" if a is None else np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def shard_map_requests(pgs, masks, seed) -> dict:
    """One rank's requests of the ``[shard_map]`` phase, in the group the
    caller started, on ``pgs`` (the graph's partition, then
    ``SERVICE_STREAM_GRAPH``'s): every case cold and warm (each timed, then
    profiled once), one reduction pass on d1 ``all_gather``, then the
    service (:func:`shard_map_service`).  Returns the results' digests,
    seconds, launches and profile counts by case."""
    import torch

    from repro_torch.core.plan import build_plan
    from repro_torch.core.reduce import reduce_colors

    pg = pgs[0]
    kernels = wrappers()
    out = {"results": {}, "seconds": {}, "launches": {}, "profile": {}, "plan_s": {},
           "service": {}}

    def timed(fn):
        torch.distributed.barrier(device_ids=[torch.cuda.current_device()])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    keep = None
    for problem, name, kw in SHARD_MAP_CASES:
        label = shard_map_label(problem, name, kw)
        for k in kernels.values():
            k.launches = 0
        plan, out["plan_s"][label] = timed(lambda: build_plan(
            pg, problem=problem, backend="cuda_fused", exchange=shard_map_exchange(name, kw),
            engine="shard_map", device="cuda", state_cache=False))
        cold, cold_s = timed(plan.run)
        c0 = np.where(masks[0], 0, cold.colors)
        warm, warm_s = timed(lambda: plan.run(color_mask=masks[0], colors0=c0))
        out["launches"][label] = {n: k.launches for n, k in kernels.items()}
        out["results"][label] = (digest(cold), digest(warm))
        out["seconds"][label] = (cold_s, warm_s)
        again, *counts = profile_counts(
            [plan.run, lambda: plan.run(color_mask=masks[0], colors0=c0)])
        if not all(same_result(a, r) for a, r in zip(again, (cold, warm))):
            raise AssertionError(f"[shard_map] {label}: a profiled request differs")
        out["profile"][label] = counts
        if (problem, name) == ("d1", "all_gather"):
            keep = plan, cold
        del plan
    plan, cold = keep
    for k in kernels.values():
        k.launches = 0
    red, red_s = timed(lambda: reduce_colors(plan, cold, passes=1, cache=False))
    out["launches"]["d1 reduce"] = {n: k.launches for n, k in kernels.items()}
    out["results"]["d1 reduce"] = (digest(red),)
    out["seconds"]["d1 reduce"] = (red_s,)
    del plan, cold, keep, red
    shard_map_service(pgs, seed, out, kernels, timed)
    return out


def shard_map_service(pgs, seed, out, kernels, timed) -> None:
    """The service on the group, as ``[service]`` drives it on one card:
    ``ColoringService.run_batch`` of ``SERVICE_BATCH`` warm 10% d1
    ``cuda_fused`` requests (``max_batch`` 8, so refills), and a
    ``ColoringFrontend`` stream of ``SERVICE_STREAM`` requests alternating
    ``pgs`` (``sparse_delta``, one reduction pass), cold then warm.  Every
    result must equal its solo run on the engine (plus ``reduce_colors``
    for the stream), or this raises; ``out`` gets their digests for the
    parent's ``simulate``, the seconds, the launches and the stats."""
    from repro_torch.core.plan import PlanCache, get_plan
    from repro_torch.core.reduce import reduce_colors
    from repro_torch.serve import ColoringFrontend, ColoringRequest, ColoringService

    def launches(label=None):
        if label is not None:
            out["launches"][label] = {n: k.launches for n, k in kernels.items()}
        for k in kernels.values():
            k.launches = 0

    svc = ColoringService(pgs[0], backend="cuda_fused", engine="shard_map",
                          device="cuda", cache=PlanCache(), max_batch=SERVICE_MAX_BATCH)
    plan = svc.plan
    reqs = warm_requests(plan, plan.run(), SERVICE_BATCH, np.random.default_rng(seed))
    solo = [timed(lambda: plan.run(**r.plan_inputs())) for r in reqs]
    counts = counting_steps(plan)
    launches()
    (got, syncs), batch_s = timed(lambda: count_syncs(lambda: svc.run_batch(reqs)))
    launches("service batch")
    for i, (a, (b, _)) in enumerate(zip(got, solo, strict=True)):
        if not same_result(a, b):
            raise AssertionError(f"[shard_map] service batch request {i}: differs from "
                                 "its solo plan.run on the engine")
    st = svc.stats
    if st.refills <= 0:
        raise AssertionError("[shard_map] service batch: no slot was refilled")
    out["results"]["service batch"] = tuple(digest(r) for r in got)
    out["seconds"]["service batch"] = (batch_s, sum(t for _, t in solo))
    out["service"]["service batch"] = (
        f"{counts['steps']} steps, {counts['transitions']} slot transitions, {syncs} host "
        f"syncs ({syncs / max(counts['steps'], 1):.1f} a step), steps {counts['step_s']:.4f}"
        f" s; batches={st.batches} refills={st.refills} cold_runs={st.cold_runs} "
        f"cold_ms={st.cold_ms:.1f} warm_ms_mean={st.warm_ms_mean:.1f}")
    del svc, plan, reqs, solo, got

    fe = ColoringFrontend(backend="cuda_fused", exchange="sparse_delta", engine="shard_map",
                          reduce_passes=1, device="cuda", cache=PlanCache(),
                          max_batch=SERVICE_MAX_BATCH)
    pairs = [(pgs[i % 2], ColoringRequest()) for i in range(SERVICE_STREAM)]
    launches()
    cold, cold_s = timed(lambda: fe.run_stream(pairs))
    warm, warm_s = timed(lambda: fe.run_stream(pairs))
    launches("service stream")
    wants = []
    for pgx in pgs:
        plan = get_plan(pgx, cache=fe.cache, **fe._cfg)     # the frontend's plan
        base = plan.run()
        wants.append(reduce_colors(plan, base, passes=1, cache=fe.cache)
                     .merged_result(base))
        for i, ((p, _), a, b) in enumerate(zip(pairs, cold, warm)):
            if p is pgx and not (same_result(a, wants[-1]) and same_result(b, wants[-1])):
                raise AssertionError(f"[shard_map] service stream request {i}: differs "
                                     "from its solo plan.run + reduce_colors on the engine")
    st = fe.stats
    out["results"]["service stream"] = tuple(digest(w) for w in wants)
    out["seconds"]["service stream"] = (cold_s, warm_s)
    out["service"]["service stream"] = (
        f"batches={st.batches} refills={st.refills} cold_runs={st.cold_runs} "
        f"cold_ms={st.cold_ms:.1f} warm_ms_mean={st.warm_ms_mean:.1f} "
        f"n_programs={fe.n_programs}")
    fe.close()


def load_partition(npz):
    """A partition :func:`shard_map_group` wrote, and the extra arrays
    beside it."""
    import dataclasses

    from repro_torch.graph.partition import PartitionedGraph

    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files}
    names = {f.name for f in dataclasses.fields(PartitionedGraph)}
    pg = PartitionedGraph(**{k: (v.item() if v.ndim == 0 else v)
                             for k, v in arrays.items() if k in names})
    return pg, {k: v for k, v in arrays.items() if k not in names}


def shard_map_rank(rank, world, npzs, rendezvous, results, seed) -> None:
    """A spawned rank of a group over ``world`` cards: joins the NCCL group,
    loads the partitions the parent wrote, runs :func:`shard_map_requests`
    and sends its output back."""
    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method=f"file://{rendezvous}", rank=rank,
                                world_size=world, device_id=torch.device("cuda", rank))
        (pg, extra), (small, _) = (load_partition(npz) for npz in npzs)
        out = shard_map_requests((pg, small), [extra["mask"]], seed)
        dist.destroy_process_group()
        results.put((rank, "ok", out))
    except BaseException:
        import traceback

        results.put((rank, "error", traceback.format_exc()))


def shard_map_group(pgs, masks, world, seed) -> list[dict]:
    """Every rank's :func:`shard_map_requests` output.  One card: a group of
    one in this process.  More: one spawned process per card, handed the
    partitions through temporary ``.npz`` files (not pickled)."""
    import dataclasses
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        rendezvous = os.path.join(tmp, "rendezvous")
        if world == 1:
            dist.init_process_group("nccl", init_method=f"file://{rendezvous}", rank=0,
                                    world_size=1, device_id=torch.device("cuda", 0))
            try:
                return [shard_map_requests(pgs, masks, seed)]
            finally:
                dist.destroy_process_group()
        npzs = []
        for i, pg in enumerate(pgs):
            npzs.append(os.path.join(tmp, f"partition{i}.npz"))
            fields = {f.name: np.asarray(getattr(pg, f.name)) for f in dataclasses.fields(pg)}
            np.savez(npzs[-1], **fields, **({"mask": masks[0]} if i == 0 else {}))
        ctx = mp.get_context("spawn")
        results = ctx.Queue()
        procs = [ctx.Process(target=shard_map_rank,
                             args=(r, world, npzs, rendezvous, results, seed))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            got = {}
            for _ in range(world):
                rank, status, payload = results.get(timeout=SHARD_MAP_LIMIT_S)
                if status != "ok":
                    raise AssertionError(f"[shard_map] rank {rank} failed:\n{payload}")
                got[rank] = payload
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        torch.cuda.synchronize()
        return [got[r] for r in range(world)]


def shard_map_phase(g, args, ledger) -> None:
    """``[shard_map]``: the multi-GPU engine over NCCL, one rank per card
    (up to ``--parts``), on the graph partitioned into one part per rank
    with a second ghost layer: d1 ``cuda_fused`` with every exchange (the
    sparse two in both transports) and d2 with ``sparse_delta``, cold and
    warm, one reduction pass on d1, and the service (a batch through
    ``ColoringService``, a stream through ``ColoringFrontend`` alternating
    the graph and ``SERVICE_STREAM_GRAPH``); every result equal in every
    field to the ``simulate`` engine on the same partition on ``cuda:0``."""
    import torch

    from repro_torch.core import validate
    from repro_torch.core.plan import build_plan
    from repro_torch.core.reduce import reduce_colors
    from repro_torch.graph.partition import partition_graph
    from repro_torch.launch.color import make_graph

    t_phase = time.perf_counter()
    world = max(1, min(torch.cuda.device_count(), args.parts))
    t0 = time.perf_counter()
    pg = partition_graph(g, world, second_layer=True)
    log(f"[shard_map] ranks={world} on {torch.cuda.device_count()} card(s): "
        f"partition into {world} part(s) with a second ghost layer "
        f"{time.perf_counter() - t0:.1f} s (n_local={pg.n_local} ghosts={pg.n_ghost} "
        f"send={pg.send_width})")
    if world == 1:
        log("[shard_map] ranks=1: a group of one in this process; no traffic "
            "crossed cards (NCCL moves nothing between cards with one rank)")
    t0 = time.perf_counter()
    small = partition_graph(make_graph(SERVICE_STREAM_GRAPH), world, second_layer=True)
    log(f"[shard_map] {small.name} for the service's stream: made and partitioned into "
        f"{world} part(s) with a second ghost layer in {time.perf_counter() - t0:.1f} s")
    masks = [np.random.default_rng(args.seed + 1).random(g.n) < 0.1]
    t0 = time.perf_counter()
    outs = shard_map_group((pg, small), masks, world, args.seed + 2)
    log(f"[shard_map] the group's requests took {time.perf_counter() - t0:.1f} s")

    # The simulate engine on the same partition, on cuda:0.
    dev = torch.device("cuda", 0)
    for problem, name, kw in SHARD_MAP_CASES:
        label = shard_map_label(problem, name, kw)
        plan = build_plan(pg, problem=problem, backend="cuda_fused",
                          exchange=shard_map_exchange(name, kw), engine="simulate",
                          device=dev, state_cache=False)
        cold, cold_s = wall_s(plan.run)
        c0 = np.where(masks[0], 0, cold.colors)
        warm, warm_s = wall_s(lambda: plan.run(color_mask=masks[0], colors0=c0))
        if (problem, name) == ("d1", "all_gather"):
            red, red_s = wall_s(lambda: reduce_colors(plan, cold, passes=1, cache=False))
            if any(o["results"]["d1 reduce"] != (digest(red),) for o in outs):
                raise AssertionError("[shard_map] d1 reduce: a rank differs from simulate")
            shard_s = max(o["seconds"]["d1 reduce"][0] for o in outs)
            log(f"[shard_map] d1 reduce 1 pass: colors {red.colors_by_pass}, "
                f"{shard_s:.4f} s (simulate {red_s:.4f} s), equal on every rank")
            book_shard_map(ledger, outs, "d1 reduce", SHARD_MAP_KERNELS["d1"])
        if kw is None and name in ("all_gather", "sparse_delta"):
            proper = getattr(validate, VALIDATORS[problem])
            if not (cold.converged and proper(g, cold.colors)):
                raise AssertionError(f"[shard_map] {label}: coloring is not proper")
        want = (digest(cold), digest(warm))
        for r, o in enumerate(outs):
            if o["results"][label] != want:
                raise AssertionError(f"[shard_map] {label}: rank {r} differs from "
                                     "simulate on cuda:0")
        del plan
        secs = [o["seconds"][label] for o in outs]
        prof = [o["profile"][label] for o in outs]
        busy = max(p[0] for p in prof)
        nccl_dev, nccl_host = sum(p[1] for p in prof), sum(p[2] for p in prof)
        log(f"[shard_map] ranks={world} {label} cuda_fused: plan "
            f"{max(o['plan_s'][label] for o in outs):.3f} s; cold "
            f"{max(s[0] for s in secs):.4f} s (simulate {cold_s:.4f}), warm "
            f"{max(s[1] for s in secs):.4f} s (simulate {warm_s:.4f}); rounds "
            f"{cold.rounds}/{warm.rounds}; bytes by round cold "
            f"{[int(b) for b in cold.comm_bytes_by_round]} warm "
            f"{[int(b) for b in warm.comm_bytes_by_round]}, [intra, inter] cold "
            f"[{cold.comm_bytes_intra}, {cold.comm_bytes_inter}]; equal to simulate in "
            f"every field on every rank")
        log(f"[shard_map]   cold and warm again in one profiler session: device busy "
            f"{busy:.3f} ms (the busiest rank), NCCL kernels {nccl_dev}, NCCL calls "
            f"{nccl_host} (all ranks)")
        if nccl_host <= 0 or nccl_dev <= 0:
            raise AssertionError(f"[shard_map] {label}: no NCCL call or kernel in the "
                                 "profiled requests")
        uses = SHARD_MAP_KERNELS[problem] + (
            ("pair_scatter",) if world > 1 and name in ("sparse_delta", "hier_delta")
            else ())
        book_shard_map(ledger, outs, label, uses)
    t0 = time.perf_counter()
    shard_map_service_check(pg, small, args.seed + 2, outs, ledger)
    torch.cuda.empty_cache()
    log(f"[shard_map] the service's simulate references {time.perf_counter() - t0:.1f} s; "
        f"phase {time.perf_counter() - t_phase:.1f} s")


def shard_map_service_check(pg, small, seed, outs, ledger) -> None:
    """The service's results on the group against ``simulate`` on
    ``cuda:0`` (the batch's requests remade from ``seed``, the stream's
    solo run and reduction once a topology), its numbers beside
    ``[service]``'s, and its paths' launches booked."""
    import torch

    from repro_torch.core.plan import build_plan
    from repro_torch.core.reduce import reduce_colors

    world, dev = len(outs), torch.device("cuda", 0)
    plan = build_plan(pg, backend="cuda_fused", engine="simulate", device=dev,
                      state_cache=False)
    reqs = warm_requests(plan, plan.run(), SERVICE_BATCH, np.random.default_rng(seed))
    want = tuple(digest(plan.run(**r.plan_inputs())) for r in reqs)
    del plan, reqs
    wants = []
    for pgx in (pg, small):
        plan = build_plan(pgx, backend="cuda_fused", exchange="sparse_delta",
                          engine="simulate", device=dev, state_cache=False)
        base = plan.run()
        wants.append(digest(reduce_colors(plan, base, passes=1, cache=False)
                            .merged_result(base)))
        del plan, base
    for label, w in zip(SHARD_MAP_SERVICE, (want, tuple(wants))):
        for r, o in enumerate(outs):
            if o["results"][label] != w:
                raise AssertionError(f"[shard_map] {label}: rank {r} differs from "
                                     "simulate on cuda:0")
    batch_s = max(o["seconds"]["service batch"][0] for o in outs)
    solo_s = max(o["seconds"]["service batch"][1] for o in outs)
    log(f"[shard_map] ranks={world} service batch: {SERVICE_BATCH} warm 10% d1 cuda_fused "
        f"requests (max_batch {SERVICE_MAX_BATCH}) equal on every rank to their solo "
        f"plan.run on the engine and to simulate on cuda:0; batch {batch_s:.4f} s "
        f"({SERVICE_BATCH / batch_s:.2f} req/s) against solo {solo_s:.4f} s summed "
        f"({SERVICE_BATCH / solo_s:.2f} req/s), {batch_s / solo_s:.2f}x; rank 0: "
        f"{outs[0]['service']['service batch']} ([service] on simulate, 8 parts: "
        f"{SERVICE_NUMBERS.get('service d1 cuda_fused batch', 'not run')})")
    cold_s = max(o["seconds"]["service stream"][0] for o in outs)
    warm_s = max(o["seconds"]["service stream"][1] for o in outs)
    log(f"[shard_map] ranks={world} service stream: {SERVICE_STREAM} requests alternating "
        f"{pg.name} and {small.name} (d1 cuda_fused, sparse_delta, reduce_passes=1) equal "
        f"on every rank to their solo plan.run + reduce_colors on the engine and to "
        f"simulate on cuda:0; cold {cold_s:.4f} s ({SERVICE_STREAM / cold_s:.2f} req/s), "
        f"warm {warm_s:.4f} s ({SERVICE_STREAM / warm_s:.2f} req/s); rank 0: "
        f"{outs[0]['service']['service stream']} ([service] on simulate, 8 parts: "
        f"{SERVICE_NUMBERS.get('service frontend stream', 'not run')})")
    d1 = SHARD_MAP_KERNELS["d1"]
    book_shard_map(ledger, outs, "service batch", d1)
    book_shard_map(ledger, outs, "service stream",
                   d1 + (("pair_scatter",) if world > 1 else ()))


def book_shard_map(ledger, outs, label, uses) -> None:
    """Book one case's launches, summed over the ranks, as a path."""
    counts = {n: sum(o["launches"][label][n] for o in outs) for n in ledger.kernels}
    ledger.paths[f"shard_map {label}"] = counts
    log(f"[main] launches on the shard_map {label} path (all ranks): {counts}")
    for name in uses:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched on the shard_map {label} path")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph", default="hex:256,256,256")
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20, help="timed calls per kernel")
    ap.add_argument("--baseline-csrc", default=None,
                    help="a directory with another version's fused_round.cu, "
                         "d2_forbidden.cu, collision.cu, pair_scatter.cu and *.cuh (for "
                         "example the parent commit's src/repro_torch/csrc): its fused_round "
                         "detection / fixed-point split, d2_assign, collision and "
                         "pair_scatter are timed beside this one's")
    ap.add_argument("--families-only", action="store_true",
                    help="run the [serve] families phase alone (no kernel is built: the "
                         "families' path launches none), with no kernels line")
    ap.add_argument("--train-only", action="store_true",
                    help="run the [train] phase alone (no kernel is built: the training "
                         "path launches none), with no kernels line")
    ap.add_argument("--sharded-only", action="store_true",
                    help="run the [sharded] phase alone (no kernel is built: the sharded "
                         "model stack launches none), with no kernels line")
    ap.add_argument("--shard-map-only", action="store_true",
                    help="build the kernels and run the [shard_map] phase alone (a "
                         "group of one rank per card, up to --parts), with no kernels "
                         "line")
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

    from repro_torch.configs import get_config
    from repro_torch.core.distributed import _table, color_distributed
    from repro_torch.core.exchange import EXCHANGES
    from repro_torch.core.plan import ColoringPlan
    from repro_torch.graph.partition import partition_graph
    from repro_torch.kernels import build
    from repro_torch.kernels.conflict import conflict_detect, conflict_detect_ref
    from repro_torch.kernels.fused_round import fused_round, fused_round_ref
    from repro_torch.kernels.scatter import pair_scatter, pair_scatter_ref
    from repro_torch.kernels.vb_bit import vb_bit_assign, vb_bit_assign_ref
    from repro_torch.launch.color import make_graph

    t_start = time.perf_counter()
    # Full float32 products for every plain version and the float32 check.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ident = card_identity()
    log(f"[card] {ident}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    if args.sharded_only:
        sharded_phase(args.seed, Launches())
        log(card_identity())
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.families_only or args.train_only:
        (families_phase if args.families_only else train_phase)(device, args.seed, Launches())
        log(card_identity())
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    build.build()
    log(f"[build] {len(build.SOURCES)} kernels in {time.perf_counter() - t0:.1f} s")
    for name in build.SOURCES:          # one line per entry function
        entry, spill = None, ""
        for line in build.ptxas_report(name).splitlines():
            if "Compiling entry" in line:   # the kernel's name and template arguments
                m = re.search(r"_cu_[0-9a-f]{8}\d+(\w+?_kernel(?:I\w*?EE)?)", line)
                entry = m.group(1) if m else line.split("'")[1]
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line and entry:
                log(f"[ptxas] {name}: {entry}: {line.split(':', 1)[1].strip()}; {spill}")
                entry = None
    baseline = {}
    if args.baseline_csrc:
        import ctypes
        from pathlib import Path

        t0 = time.perf_counter()
        paths = build.build(BASELINE_SOURCES, csrc=Path(args.baseline_csrc))
        baseline = {name: ctypes.CDLL(str(path)) for name, path in paths.items()}
        log(f"[build] {', '.join(BASELINE_SOURCES)} of {args.baseline_csrc} in "
            f"{time.perf_counter() - t0:.1f} s")

    if args.shard_map_only:
        shard_map_phase(make_graph(args.graph), args, Launches())
        log(card_identity())
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

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
                                lambda: color_distributed(pg, backend="cuda", device=device,
                                                          cache=False))
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
    ledger.end("d1 cuda", ("vb_bit_assign", "collision", "conflict_detect"))

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
    fused_round_split("d1", (st["adj_cidx"], colors, ghost, st["deg_tab"], st["gid_tab"],
                             st["is_boundary"]), {"problem": "d1"}, args.reps,
                     baseline.get("fused_round"))
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
    fused_round_split("d1 with pairs", pair_args, {"problem": "d1"}, args.reps,
                     baseline.get("fused_round"))
    # collision on the cold d1 request's first iteration (every row active).
    time_collision("d1 cuda cold first iteration", st, (st["adj_cidx"], None),
                   d1_first_iteration(plan, device), args.reps, baseline.get("collision"))
    del plan, st, vb_args, cf_args, tab, ctab, colors, ghost, pair_args, pslots

    # d1, cuda_fused: the same four requests.
    ledger.start()
    fused, _ = ledger.timed("d1 cuda_fused cold color_distributed",
                            lambda: color_distributed(pg, backend="cuda_fused",
                                                      device=device, cache=False))
    fplan = ColoringPlan(pg, backend="cuda_fused", device=device)
    fused = [fused]
    for i, (m, c0) in enumerate(zip(masks, colors0)):
        fused.append(ledger.timed(f"d1 cuda_fused warm {i + 1}",
                                  lambda: fplan.run(color_mask=m, colors0=c0))[0])
    ledger.end("d1 cuda_fused", ("vb_bit_assign", "collision", "fused_round"))
    check_results("d1 cuda_fused", g, "d1", fused, refs)
    profile_request("d1 cuda_fused warm",
                    lambda: fplan.run(color_mask=masks[0], colors0=colors0[0]))
    del fplan

    # The ghost exchanges on cuda_fused, one plan each, the same requests.
    # The sparse two, named under cuda_fused, scatter with pair_scatter.
    for name in ("halo", "delta", "sparse_delta", "hier_delta"):
        scatter = name in ("sparse_delta", "hier_delta")
        ledger.start()
        t0 = time.perf_counter()
        xplan = ColoringPlan(pg, backend="cuda_fused", exchange=name, device=device)
        torch.cuda.synchronize()
        log(f"[main] d1 {name} plan upload (route plan included) "
            f"{time.perf_counter() - t0:.3f} s")
        got = [ledger.timed(f"d1 {name} cold", xplan.run)[0]]
        for i, (m, c0) in enumerate(zip(masks, colors0)):
            got.append(ledger.timed(f"d1 {name} warm {i + 1}",
                                    lambda: xplan.run(color_mask=m, colors0=c0))[0])
        ledger.end(f"d1 {name}", ("vb_bit_assign", "collision", "fused_round")
                   + (("pair_scatter",) if scatter else ()))
        check_exchange(f"d1 {name}", g, "d1", got, fused)
        if scatter:
            rplan = ColoringPlan(pg, backend="cuda_fused",
                                 exchange=EXCHANGES[name](scatter="reference"),
                                 device=device)
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
            entries["pair_scatter"] = {
                **kernel_entry("pair_scatter", "src/repro_torch/csrc/pair_scatter.cu",
                               "src/repro/kernels/scatter.py:62", {}),
                **time_pair_scatter(ps_args, args.reps, baseline.get("pair_scatter"))}
            del colors, ghost, ps_args
        del xplan
    log(f"[memory] d1: peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")

    # The distance-2 family on the same graph with a second ghost layer.
    t0 = time.perf_counter()
    pg2 = partition_graph(g, args.parts, second_layer=True)
    log(f"[graph] partition with a second ghost layer {time.perf_counter() - t0:.1f} s "
        f"(n_local={pg2.n_local} ghosts={pg2.n_ghost} send={pg2.send_width})")
    for problem in ("d2", "pd2"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # The phase's peak, window by window: each kernel backend resets the
        # peak before its requests, and its window holds its timings too.
        peaks, window = {}, "reference"
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
        for backend, uses in (("cuda", ("d2_assign", "collision", "conflict_detect")),
                              ("cuda_fused", ("d2_assign", "collision", "fused_round"))):
            kplan = ColoringPlan(pg2, problem=problem, backend=backend, device=device)
            torch.cuda.synchronize()
            peaks[window], window = torch.cuda.max_memory_allocated() / 2**30, backend
            torch.cuda.reset_peak_memory_stats()
            ledger.start()
            got = [ledger.timed(f"{problem} {backend} cold", kplan.run)[0],
                   ledger.timed(f"{problem} {backend} warm 1",
                                lambda: kplan.run(color_mask=masks[0], colors0=c0))[0]]
            ledger.end(f"{problem} {backend}", uses)
            log(f"[memory] {problem} {backend}: peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated over its "
                "cold and warm requests (its plan's state included)")
            check_results(f"{problem} {backend}", g, problem, got, refs)
            if backend == "cuda_fused":
                fused = got
            if problem == "d2" and backend == "cuda_fused":
                profile_request("d2 cuda_fused warm",
                                lambda: kplan.run(color_mask=masks[0], colors0=c0))
            if problem == "d2" and backend == "cuda":
                # d2_assign and collision: the first iteration of the cold
                # run (every active row uncolored), and d2_assign's of the
                # warm one (the cleared 10%).
                st = kplan._st
                cold = d2_first_iteration(kplan, device)
                entries["d2_assign"] = kernel_entry(
                    "d2_assign", "src/repro_torch/csrc/d2_forbidden.cu",
                    "src/repro/kernels/d2_forbidden.py:89",
                    time_d2_assign("cold d2 first iteration", st, cold, args.reps,
                                   baseline.get("d2_forbidden")))
                d2_blocks = (st["two_hop_cidx"], st["adj_cidx"])
                entries["collision"] = kernel_entry(
                    "collision", "src/repro_torch/csrc/collision.cu",
                    "none: src/repro/kernels/ops.py:72-80, :146-160 (jnp)",
                    time_collision("cold d2 first iteration", st, d2_blocks,
                                   d2_collision_inputs(st, cold), args.reps,
                                   baseline.get("collision"),
                                   whole_table_test(st, cold[1])))
                del cold
                warm = d2_first_iteration(kplan, device, masks[0], c0)
                time_d2_assign("warm 10% d2 first iteration", st, warm, args.reps,
                               baseline.get("d2_forbidden"))
                time_collision("warm 10% d2 first iteration", st, d2_blocks,
                               d2_collision_inputs(st, warm), args.reps,
                               baseline.get("collision"))
                del st, warm, d2_blocks
            if backend == "cuda_fused":
                # fused_round on d2 and pd2: the first round of the cold run,
                # timed for PERF.md beside the d1 entry of the kernels line.
                st = kplan._st
                colors, ghost = first_round_inputs(kplan, problem, device)
                nbytes, iters = fused_round_bytes(st, colors, ghost, problem, True)
                log(f"[time] fused_round {problem} first-round inputs: the plain fixed "
                    f"point takes {iters} iterations")
                d2_args = (st["adj_cidx"], colors, ghost, st["deg_tab"], st["gid_tab"],
                           st["is_boundary"], st["two_hop_cidx"])
                time_kernel(f"fused_round {problem}", fused_round, fused_round_ref,
                            d2_args, {"problem": problem}, nbytes, args.reps)
                if problem == "d2":
                    fused_round_split("d2", d2_args, {"problem": "d2"}, args.reps,
                                      baseline.get("fused_round"))
                del d2_args, st, colors, ghost
            del kplan
        if problem == "d2":
            # The sparse exchanges on d2, against all_gather on cuda_fused.
            for name in ("sparse_delta", "hier_delta"):
                ledger.start()
                xplan = ColoringPlan(pg2, problem="d2", backend="cuda_fused",
                                     exchange=name, device=device)
                got = [ledger.timed(f"d2 {name} cold", xplan.run)[0],
                       ledger.timed(f"d2 {name} warm 1",
                                    lambda: xplan.run(color_mask=masks[0], colors0=c0))[0]]
                ledger.end(f"d2 {name}", ("d2_assign", "collision", "fused_round",
                                          "pair_scatter"))
                check_exchange(f"d2 {name}", g, "d2", got, fused)
                del xplan
        peaks[window] = torch.cuda.max_memory_allocated() / 2**30
        log(f"[memory] {problem}: peak {max(peaks.values()):.2f} GiB allocated over the "
            "phase; by window (from one reset to the next: the reference backend, then "
            "each kernel backend with its timings"
            + (" and the exchanges" if problem == "d2" else "") + "): "
            + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items()))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ref = color_distributed(pg2, problem="d1_2gl", backend="reference", device=device,
                            cache=False)
    for backend in ("cuda", "cuda_fused"):
        ledger.start()
        got, _ = ledger.timed(f"d1_2gl {backend} cold color_distributed",
                              lambda: color_distributed(pg2, problem="d1_2gl",
                                                        backend=backend, device=device,
                                                        cache=False))
        ledger.end(f"d1_2gl {backend}", ("vb_bit_assign", "collision", "conflict_detect"))
        check_results(f"d1_2gl {backend}", g, "d1_2gl", [got], [ref])
    log(f"[memory] d1_2gl: peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        "GiB allocated")
    del ref, got, fused, refs, results, masks, colors0

    # -- the plan cache, color reduction and the comparison points -----------------
    plans_phase(pg, pg2, device, ledger)
    reduce_phase(g, pg, pg2, device, ledger)
    baseline_phase(g, pg, device)
    service_phase(pg, pg2, device, ledger, args.seed)
    del pg, pg2
    shard_map_phase(g, args, ledger)
    del g

    # -- 4. serving, and flash_attention on the served model's tensors -------------
    t0 = time.perf_counter()
    entries["flash_attention"] = {
        **kernel_entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                       "src/repro/kernels/flash_attention.py:96", {}),
        **serve_phase(device, args.seed, get_config(SERVE_ARCH), ledger, args.reps)}
    log(f"[serve] the serving and flash phases took {time.perf_counter() - t0:.1f} s")
    families_phase(device, args.seed, ledger)

    # -- 5. training, on one card and on a mesh ----------------------------------
    train_phase(device, args.seed, ledger)
    sharded_phase(args.seed, ledger)

    # -- 6. the kernels line ----------------------------------------------------
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
