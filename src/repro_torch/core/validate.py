"""Proper-coloring validators (host-side, exact).

These are the correctness oracles for every test and benchmark: a
distributed run is correct iff the gathered global coloring passes the
validator for its problem variant.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import Graph

__all__ = [
    "is_proper_d1",
    "is_proper_d2",
    "is_proper_pd2",
    "num_colors",
    "count_conflicts_d1",
    "color_histogram",
    "is_balanced",
]


def num_colors(colors: np.ndarray) -> int:
    c = colors[colors > 0]
    return int(np.unique(c).size)


def color_histogram(colors: np.ndarray, *, minlength: int = 0) -> np.ndarray:
    """Color-class sizes: ``h[c]`` = vertices with color ``c``.

    ``h[0]`` counts uncolored vertices; the length is
    ``max(colors.max()+1, minlength)``.  This is the host-side oracle the
    device quality metrics (``core/quality.py``, still to port) are pinned
    against, so the two definitions cannot drift.
    """
    colors = np.asarray(colors)
    return np.bincount(colors[colors >= 0].astype(np.int64),
                       minlength=max(minlength, 1))


def is_balanced(colors: np.ndarray, *, tol: float = 1.25) -> bool:
    """True when the largest color class is within ``tol`` × the mean
    class size (over non-empty classes) — the balanced-coloring criterion
    quality metrics report as ``balance``."""
    h = color_histogram(colors)[1:]
    h = h[h > 0]
    if h.size == 0:
        return True
    return float(h.max()) <= tol * float(h.mean())


def count_conflicts_d1(graph: Graph, colors: np.ndarray) -> int:
    src = np.repeat(np.arange(graph.n), np.diff(graph.offsets))
    bad = (colors[src] == colors[graph.targets]) & (colors[src] > 0)
    return int(bad.sum()) // 2


def is_proper_d1(graph: Graph, colors: np.ndarray, *, require_complete: bool = True) -> bool:
    if require_complete and (colors[: graph.n] <= 0).any():
        return False
    return count_conflicts_d1(graph, colors) == 0


def _neighborhood_pairwise_distinct(graph: Graph, colors: np.ndarray) -> bool:
    """For every vertex u, colors of N(u) are pairwise distinct.

    Covers exactly the two-hop pairs: v,w within distance 2 iff they share
    a common neighbor u (or are adjacent — checked separately for D2).
    """
    for u in range(graph.n):
        nc = colors[graph.neighbors(u)]
        nc = nc[nc > 0]
        if nc.size != np.unique(nc).size:
            return False
    return True


def is_proper_d2(graph: Graph, colors: np.ndarray, *, require_complete: bool = True) -> bool:
    if require_complete and (colors[: graph.n] <= 0).any():
        return False
    if count_conflicts_d1(graph, colors) != 0:
        return False
    return _neighborhood_pairwise_distinct(graph, colors)


def is_proper_pd2(graph: Graph, colors: np.ndarray, *, require_complete: bool = True) -> bool:
    """Partial distance-2: only two-hop pairs must differ (§3.6)."""
    if require_complete and (colors[: graph.n] <= 0).any():
        return False
    return _neighborhood_pairwise_distinct(graph, colors)
