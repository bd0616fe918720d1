"""Serial greedy coloring oracle (paper Algorithm 1) — host-side numpy.

This is the quality baseline every parallel variant is compared against
(the paper reports color counts relative to single-device / serial runs).
Supports the classic orderings discussed in §2.2: natural, largest-first,
and smallest-last.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import Graph

__all__ = ["greedy_d1", "greedy_d2", "greedy_pd2", "vertex_order"]


def vertex_order(graph: Graph, order: str = "natural") -> np.ndarray:
    if order == "natural":
        return np.arange(graph.n, dtype=np.int64)
    if order == "largest_first":
        return np.argsort(-graph.degrees, kind="stable").astype(np.int64)
    if order == "smallest_last":
        # Repeatedly remove the min-degree vertex; color in reverse removal
        # order.  O(n log n) lazy-heap implementation.
        import heapq

        deg = graph.degrees.astype(np.int64).copy()
        removed = np.zeros(graph.n, dtype=bool)
        heap = [(int(d), int(v)) for v, d in enumerate(deg)]
        heapq.heapify(heap)
        out = []
        while heap:
            d, v = heapq.heappop(heap)
            if removed[v] or d != deg[v]:
                continue
            removed[v] = True
            out.append(v)
            for u in graph.neighbors(v):
                if not removed[u]:
                    deg[u] -= 1
                    heapq.heappush(heap, (int(deg[u]), int(u)))
        return np.array(out[::-1], dtype=np.int64)
    raise ValueError(f"unknown order: {order}")


def greedy_d1(graph: Graph, order: str = "natural") -> np.ndarray:
    """Distance-1 serial greedy; colors are 1-based."""
    colors = np.zeros(graph.n, dtype=np.int32)
    scratch = np.zeros(graph.n + 2, dtype=np.int64)  # forbidden stamps
    stamp = 0
    for v in vertex_order(graph, order):
        stamp += 1
        nc = colors[graph.neighbors(v)]
        scratch[nc[nc > 0]] = stamp
        c = 1
        while scratch[c] == stamp:
            c += 1
        colors[v] = c
    return colors


def _two_hop_forbid(graph: Graph, v: int, colors: np.ndarray, scratch, stamp, include_d1: bool):
    nbrs = graph.neighbors(v)
    if include_d1:
        nc = colors[nbrs]
        scratch[nc[nc > 0]] = stamp
    for u in nbrs:
        nc2 = colors[graph.neighbors(u)]
        nc2 = nc2[nc2 > 0]
        scratch[nc2] = stamp


def greedy_d2(graph: Graph, order: str = "natural") -> np.ndarray:
    """Distance-2 serial greedy (all pairs within two hops differ)."""
    colors = np.zeros(graph.n, dtype=np.int32)
    scratch = np.zeros(graph.n + 2, dtype=np.int64)
    stamp = 0
    for v in vertex_order(graph, order):
        stamp += 1
        _two_hop_forbid(graph, v, colors, scratch, stamp, include_d1=True)
        scratch[colors[v]] = 0  # self excluded (colors[v] is 0 anyway)
        c = 1
        while scratch[c] == stamp:
            c += 1
        colors[v] = c
    return colors


def greedy_pd2(graph: Graph, order: str = "natural") -> np.ndarray:
    """Partial distance-2 serial greedy (two-hop pairs only, §3.6)."""
    colors = np.zeros(graph.n, dtype=np.int32)
    scratch = np.zeros(graph.n + 2, dtype=np.int64)
    stamp = 0
    for v in vertex_order(graph, order):
        stamp += 1
        _two_hop_forbid(graph, v, colors, scratch, stamp, include_d1=False)
        c = 1
        while scratch[c] == stamp:
            c += 1
        colors[v] = c
    return colors
