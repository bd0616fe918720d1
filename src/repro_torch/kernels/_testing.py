"""Random kernel inputs shared by the kernel tests and ``chip_smoke.py``.

Inputs are drawn per part as ``tests/test_kernels.py`` draws them for the
JAX kernels, so the port's kernels and plain versions see the same cases.
"""
from __future__ import annotations

import numpy as np

__all__ = ["SHAPES", "random_part", "random_stacked"]

# (rows, lanes, ghosts) of tests/test_kernels.py.
SHAPES = [(16, 3, 8), (100, 7, 40), (256, 1, 1), (515, 12, 200), (64, 33, 9)]


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
