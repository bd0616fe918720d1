"""Random kernel inputs shared by the kernel tests and ``chip_smoke.py``.

Inputs are drawn per part as ``tests/test_kernels.py`` draws them for the
JAX kernels, so the port's kernels and plain versions see the same cases.
"""
from __future__ import annotations

import numpy as np

__all__ = ["SHAPES", "D2_SHAPES", "ROUND_SHAPES", "SCATTER_SHAPES", "FLASH_SHAPES",
           "random_part", "random_stacked", "random_ext", "random_round", "random_pairs",
           "round_pairs", "random_qkv"]

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
# (batch, Lq, Lk, q heads, kv heads, dh, causal, block_q, block_k) of the
# flash-attention cases: the four of
# tests/test_extensions.py::test_flash_attention_sweep; then query groups
# of 1, 2, 4 and 8 over every head width the kernel takes, causal and
# full, at lengths that are no multiple of the kernel's 64-row tile; and
# causal with fewer and with more queries than keys.
FLASH_SHAPES = [(2, 128, 128, 4, 2, 64, True, 64, 64), (1, 256, 256, 8, 8, 32, True, 128, 128),
                (2, 64, 64, 4, 1, 16, False, 32, 16), (1, 96, 96, 2, 2, 8, True, 32, 32)] + [
    (2, 160, 160 if causal else 96, g * (1 if g == 8 else 2), 1 if g == 8 else 2, dh,
     causal, 32, 32)
    for g in (1, 2, 4, 8) for dh in (8, 16, 32, 64, 128) for causal in (True, False)
] + [(1, 96, 160, 4, 2, 64, True, 32, 32), (1, 160, 96, 4, 2, 64, True, 32, 32)]


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
