"""Random kernel inputs shared by the kernel tests and ``chip_smoke.py``.

Inputs are drawn per part as ``tests/test_kernels.py`` draws them for the
JAX kernels, so the port's kernels and plain versions see the same cases.
"""
from __future__ import annotations

import numpy as np

__all__ = ["SHAPES", "D2_SHAPES", "ROUND_SHAPES", "ROUND_EDGES", "SCATTER_SHAPES",
           "FLASH_SHAPES", "ROW_TOL", "max_row_error", "random_part", "random_stacked",
           "random_ext", "random_round", "round_edge", "random_pairs", "round_pairs",
           "random_qkv", "FIXED_POINT_SHAPES", "random_fixed_point", "SCATTER_EDGES",
           "scatter_edge", "COLLISION_EDGES", "random_collision", "collision_lists_of"]

# (rows, lanes, ghosts) of tests/test_kernels.py.
SHAPES = [(16, 3, 8), (100, 7, 40), (256, 1, 1), (515, 12, 200), (64, 33, 9)]
# (rows, lanes, ghosts) of tests/test_kernels.py::test_d2_forbidden_sweep.
D2_SHAPES = [(16, 3, 8), (64, 5, 30), (130, 9, 60)]
# (rows, lanes, ghosts, real ghosts) of the fused-round cases: ragged row
# counts, and one ghost slot that holds no real ghost (a single part's).
ROUND_SHAPES = [(100, 7, 40, True), (515, 5, 200, True), (256, 4, 1, False),
                (1000, 3, 64, True)]
# (rows, table width S, pairs per row C, real pairs per row or None =
# random) of the pair-scatter cases: the (S, C) of
# tests/test_kernels.py::test_pair_scatter_sweep over 1 to 64 rows, C up
# to S, a case with no real pair and one with every slot real.
SCATTER_SHAPES = [(1, 16, 5, None), (3, 100, 100, None), (4, 257, 64, None),
                  (2, 512, 1, None), (64, 300, 300, None), (5, 40, 40, 0),
                  (7, 33, 33, 33)]
# (rows, S, C, real pairs per row or None = random, table row stride,
# table offset into its row, offset + S <= stride) of the pair-scatter edge cases: S no multiple of 4; a
# table row stride that leaves rows unaligned, and a table view that starts
# off a 16-byte boundary; one row over several blocks of a cluster (5, and
# the 8 of the largest cluster); more rows than one cluster or one block
# covers (20 clusters of 3 blocks; 300 rows of 16 words, two blocks of 256
# rows); C below and above S; all pads; every slot real.
SCATTER_EDGES = [(3, 131, 131, None, 131, 0), (4, 100, 100, None, 103, 0),
                 (3, 257, 64, None, 260, 1), (1, 20000, 20000, None, 20000, 0),
                 (1, 40000, 12000, None, 40003, 3), (20, 9000, 9000, None, 9000, 0),
                 (300, 16, 16, None, 16, 0), (5, 1000, 37, None, 1000, 0),
                 (2, 50, 300, None, 50, 0), (6, 5000, 5000, 0, 5000, 0),
                 (4, 4099, 4099, 4099, 4099, 0)]
# (rows, lanes_a, lanes_b, ghosts) of the collision edge cases: 1, 6, 8, 9,
# 17, 33, 42 (two-hop 36 and one-hop 6, as d2 on a hex mesh), 64 and 100
# lanes a row, on both sides of the kernel's first 8 lanes and of its
# chunks of 40 lanes beyond them.
COLLISION_EDGES = [(300, 1, 0, 100), (300, 6, 0, 120), (200, 8, 0, 60), (200, 5, 4, 60),
                   (200, 9, 8, 60), (200, 33, 0, 80), (200, 36, 6, 90), (150, 64, 0, 60),
                   (120, 60, 40, 50)]
# The fused-round edge cases, each at d1, d2 and pd2, with and without
# pairs: (name, rows, lanes, ghosts) for :func:`round_edge`.
ROUND_EDGES = [("all_lose", 300, 5, 120), ("none_lose", 300, 5, 120),
               ("one_part_slow", 400, 6, 160)]
# (batch, Lq, Lk, q heads, kv heads, dh, causal, block_q, block_k) of the
# flash-attention cases: the four of
# tests/test_extensions.py::test_flash_attention_sweep; then query groups
# of 1, 2, 4 and 8 over every head width the kernel takes, causal and
# full, at lengths that are no multiple of the kernel's 64-row tile; then
# causal with fewer and with more queries than keys; lengths ragged
# against the 128-query and 128-key tiles of the wgmma body, causal with
# fewer and more queries than keys at dh 64 and 128 over several key
# tiles; and batch * q heads = 65,600 at a tiny length.
FLASH_SHAPES = [(2, 128, 128, 4, 2, 64, True, 64, 64), (1, 256, 256, 8, 8, 32, True, 128, 128),
                (2, 64, 64, 4, 1, 16, False, 32, 16), (1, 96, 96, 2, 2, 8, True, 32, 32)] + [
    (2, 160, 160 if causal else 96, g * (1 if g == 8 else 2), 1 if g == 8 else 2, dh,
     causal, 32, 32)
    for g in (1, 2, 4, 8) for dh in (8, 16, 32, 64, 80, 128) for causal in (True, False)
] + [(1, 96, 160, 4, 2, 64, True, 32, 32), (1, 160, 96, 4, 2, 64, True, 32, 32)] + [
    (2, 200, 200, 4, 2, 64, True, 200, 200), (2, 129, 129, 8, 2, 128, True, 129, 129),
    (1, 200, 200, 4, 1, 128, False, 200, 200), (3, 129, 129, 2, 2, 64, False, 129, 129),
    (1, 200, 330, 4, 2, 64, True, 200, 330), (1, 330, 200, 4, 2, 64, True, 330, 200),
    (1, 130, 300, 8, 1, 128, True, 130, 300), (1, 300, 130, 8, 1, 128, True, 300, 130),
    (1, 129, 257, 16, 2, 80, True, 129, 257), (2050, 16, 16, 32, 4, 16, True, 16, 16),
    (1025, 16, 16, 64, 8, 64, False, 16, 16),
]
# (rows, lanes, ghosts) of the local fixed points' cases (kernels/ops.py).
FIXED_POINT_SHAPES = [(120, 5, 48), (515, 6, 200)]
# Every output row of a bf16 attention within ROW_TOL of the reference
# row, relative to that row's 2-norm.  A row's elements shrink as
# 1/sqrt(keys seen), so a fixed atol passes a dropped key tile in late
# rows; the row's own norm scales with it.  bf16's unit roundoff is 2**-8
# = 3.9e-3, and two attentions that round P and the output at different
# points differ by a few units in a row's norm.
ROW_TOL = 2e-2


def max_row_error(got, want) -> float:
    """The largest ``|got - want|`` over the last axis relative to ``want``'s
    norm there, both compared in float32."""
    got, want = got.float(), want.float()
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)).max())


def random_part(n, w, n_ghost, n_colors, seed, deg_max=50):
    """One part's ``(adj, tab, base, active, deg_tab, gid_tab, is_boundary)``."""
    rng = np.random.default_rng(seed)
    n_tab = n + n_ghost + 1
    adj = rng.integers(0, n_tab, (n, w)).astype(np.int32)
    tab = np.concatenate([
        rng.integers(0, n_colors + 1, n + n_ghost), [0]]).astype(np.int32)
    base = rng.integers(1, 40, n).astype(np.int32)
    active = rng.random(n) < 0.8
    deg_tab = np.concatenate([
        rng.integers(0, deg_max, n + n_ghost), [0]]).astype(np.int32)
    gid_tab = np.concatenate([
        rng.permutation(10 * (n + n_ghost))[: n + n_ghost], [2**31 - 2]
    ]).astype(np.int32)
    bd = rng.random(n) < 0.5
    return adj, tab, base, active, deg_tab, gid_tab, bd


def random_stacked(n, w, g, n_colors, seed, parts):
    """``(per_part, stacked)``: each part's arrays, and the same stacked
    over a leading part axis.  Part ``p`` draws from ``seed + 1000 * p``."""
    per = [random_part(n, w, g, n_colors, seed + 1000 * p) for p in range(parts)]
    return per, [np.stack(x) for x in zip(*per)]


def random_ext(n, w, g, seed, parts):
    """``(P, n+g+1, w)`` random extended adjacency, part ``p`` drawn from
    ``seed + 1000 * p`` as ``tests/test_kernels.py`` draws one part's."""
    return np.stack([
        np.random.default_rng(seed + 1000 * p).integers(0, n + g + 1, (n + g + 1, w))
        .astype(np.int32) for p in range(parts)])


def random_round(n, w, g, seed, parts, *, real_ghosts=True):
    """Stacked inputs of one coloring round on random tables:
    ``(adj, two_hop, colors, ghost, deg_tab, gid_tab, is_boundary)``.

    Colors and ghost colors come from a few values so that many owned rows
    collide with ghosts; ``two_hop`` is the random extended adjacency
    gathered through ``adj``, as ``build_device_state`` builds it.  Without
    ``real_ghosts`` the ghost colors are 0, as the one ghost slot of a
    single part is.
    """
    _, (adj, tab, _, _, deg, gid, bd) = random_stacked(n, w, g, 6, seed, parts)
    ext = random_ext(n, w, g, seed + 7, parts)
    two_hop = ext[np.arange(parts)[:, None, None], adj].reshape(parts, n, w * w)
    ghost = tab[:, n:n + g].copy()
    if not real_ghosts:
        ghost[:] = 0
    return adj, two_hop, tab[:, :n].copy(), ghost, deg, gid, bd


def round_edge(name, n, w, g, seed, parts):
    """Stacked inputs of one coloring round, as :func:`random_round`, made
    for an edge of the recolor fixed point:

    - ``all_lose``: every row is a colored boundary row whose ghost lanes
      all hold its color and whose ghosts all win (higher degree), so every
      row loses and is recolored;
    - ``none_lose``: every row is colored and no ghost holds a row's color,
      so no row loses and the list of rows to recolor stays empty;
    - ``one_part_slow``: part 0 as ``all_lose`` on a dense owned graph (its
      fixed point takes many iterations), every other part with one
      losing row, so the other parts stop iterating long before part 0.
    """
    adj, two_hop, colors, ghost, deg, gid, bd = random_round(n, w, g, seed, parts)
    rng = np.random.default_rng(seed + 99)
    if name == "none_lose":
        colors[:] = 7 + rng.integers(0, 3, colors.shape)
        ghost[:] = rng.integers(1, 7, ghost.shape)
        return adj, two_hop, colors, ghost, deg, gid, bd
    if name not in ("all_lose", "one_part_slow"):
        raise ValueError(f"unknown round edge case {name!r}")
    colors[:] = 1
    ghost[:] = 1
    bd[:] = True
    lanes = rng.integers(n, n + g, adj.shape).astype(np.int32)
    if name == "one_part_slow":
        # Part 0: one ghost lane a row, the rest owned neighbours (a
        # dense owned graph recolors over many speculative iterations).
        lanes[0, :, 1:] = rng.integers(0, n, (n, adj.shape[-1] - 1))
    adj[:] = lanes
    deg[:, :n] = 1
    deg[:, n:n + g] = 1000             # every ghost outranks every row
    if name == "one_part_slow":
        colors[1:] = 2                 # other parts: only row 0 collides
        colors[1:, 0] = 1
        deg[0, :n] = rng.integers(1, 5, n)   # part 0: ties broken by degree and hash
    ext = random_ext(n, adj.shape[-1], g, seed + 7, parts)
    two_hop = ext[np.arange(parts)[:, None, None], adj].reshape(parts, n, -1)
    return adj, two_hop, colors, ghost, deg, gid, bd


def random_fixed_point(n, w, g, seed, parts):
    """Stacked inputs of a local fixed point on random tables:
    ``(adj, ext, two_hop, tab, active, deg_tab, gid_tab)``.

    As :func:`random_round` draws them (asymmetric lanes, colors from a few
    values, so that many rows collide), with each part's share of
    uncolored rows ``(0.9, 0, 0.3)[p % 3]``: part 0 recolors most of its
    rows over several iterations, part 1 has every active row colored on
    entry (it does not run, though some of its active rows collide with a
    ghost), part 2 warm-starts and stops earlier than part 0.
    """
    _, (adj, tab, _, active, deg, gid, _) = random_stacked(n, w, g, 6, seed, parts)
    ext = random_ext(n, w, g, seed + 7, parts)
    two_hop = ext[np.arange(parts)[:, None, None], adj].reshape(parts, n, w * w)
    rng = np.random.default_rng(seed + 5)
    for p in range(parts):
        tab[p, :n][rng.random(n) < (0.9, 0.0, 0.3)[p % 3]] = 0
    tab[1::3, :n][active[1::3] & (tab[1::3, :n] == 0)] = 1
    return adj, ext, two_hop, tab, active, deg, gid


def random_pairs(rows, s, c, seed, k=None):
    """``(table (rows, s), slots (rows, c), values (rows, c))`` int32.

    Each row draws as ``tests/test_kernels.py::test_pair_scatter_sweep``
    draws its one row (row ``r`` from ``seed + 1000 * r``): ``k`` real
    pairs (random in ``0..min(s, c)`` unless given) with unique slots, the
    rest padding at the sentinel slot ``s``; the pairs are then shuffled,
    so padding sits anywhere in the row.
    """
    tabs, slots, vals = [], [], []
    for r in range(rows):
        rng = np.random.default_rng(seed + 1000 * r)
        tabs.append(rng.integers(0, 99, s).astype(np.int32))
        kr = int(rng.integers(0, min(s, c) + 1)) if k is None else k
        sl = np.full(c, s, np.int32)
        sl[:kr] = rng.permutation(s)[:kr]
        slots.append(rng.permutation(sl))
        vals.append(rng.integers(1, 50, c).astype(np.int32))
    return np.stack(tabs), np.stack(slots), np.stack(vals)


def round_pairs(g, seed, parts):
    """``(pair_slots, pair_colors)``, ``(parts, C)`` int32 ghost updates for
    a round with ``g`` ghost slots, each part drawn as
    ``tests/test_kernels.py::test_fused_round_pairs_d1_d2`` draws its one
    part (part ``p`` from ``seed + 1000 * p``): capacity ``C = max(g // 2,
    1)``, ``C // 2`` real pairs on unique slots, the rest at the sentinel
    slot ``g``."""
    c = max(g // 2, 1)
    slots = np.full((parts, c), g, np.int32)
    vals = np.empty((parts, c), np.int32)
    for p in range(parts):
        rng = np.random.default_rng(seed + 1000 * p)
        slots[p, :c // 2] = rng.permutation(g)[:c // 2]
        vals[p] = rng.integers(1, 7, c)
    return slots, vals


def random_qkv(b, lq, lk, hq, hkv, dh, seed):
    """Standard-normal float32 ``(q, k, v)`` in the ``(B, L, H, dh)`` layout."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, lq, hq, dh), dtype=np.float32),
            rng.standard_normal((b, lk, hkv, dh), dtype=np.float32),
            rng.standard_normal((b, lk, hkv, dh), dtype=np.float32))


def scatter_edge(rows, s, c, k, ps, off, seed):
    """One :data:`SCATTER_EDGES` case: ``(wide, slots, values)`` int32, the
    table being ``wide[:, off:off + s]`` (row stride ``ps``), drawn as
    :func:`random_pairs` draws it."""
    table, slots, vals = random_pairs(rows, s, c, seed, k=k)
    wide = np.zeros((rows, ps), np.int32)
    wide[:, off:off + s] = table
    return wide, slots, vals


def random_collision(n, wa, wb, g, seed, parts):
    """One :data:`COLLISION_EDGES` case on ``parts`` parts, drawn per part as
    :func:`random_fixed_point` draws its tables: ``(lanes_a, lanes_b or
    None, tab, active, deg_tab, gid_tab, newc, cur)``.  Lanes are random
    entries of the table (asymmetric; a row may name itself), colors come
    from a few values so that many lanes collide, the active uncolored rows
    take a new color in ``0..6`` (0: none) and every other row keeps its
    own; every part runs but the last of three."""
    _, (_, tab, _, active, deg, gid, _) = random_stacked(n, 1, g, 6, seed, parts)
    rng = np.random.default_rng(seed + 3)
    lanes_a = rng.integers(0, n + g + 1, (parts, n, wa)).astype(np.int32)
    lanes_b = rng.integers(0, n + g + 1, (parts, n, wb)).astype(np.int32) if wb else None
    newc = tab[:, :n].copy()
    todo = active & (newc == 0)
    newc[todo] = rng.integers(0, 7, int(todo.sum()))
    cur = np.zeros(parts + 2, np.int32)
    cur[:parts] = todo.any(axis=1)
    if parts == 3:
        cur[2] = 0
    return lanes_a, lanes_b, tab, active, deg, gid, newc, cur


def collision_lists_of(active, seed):
    """``{"dense": every active row in order, "sparse": a seventh of them
    shuffled, "empty": none}``, int32 entries ``p * R + r``."""
    every = np.flatnonzero(active).astype(np.int32)
    rng = np.random.default_rng(seed)
    return {"dense": every, "sparse": rng.permutation(every)[:len(every) // 7],
            "empty": every[:0]}
