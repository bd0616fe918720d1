"""CSR / ELL graph structures.

Graphs are undirected, stored as symmetric CSR built on host (numpy) and
exported to ELL-padded adjacency for the TPU kernels.  Preprocessing matches
the paper: self-loops and multi-edges removed (Table 1 note).

ELL layout: ``adj[v, k]`` holds the k-th neighbor's *global* vertex id, or
``SENTINEL`` (= -1) past the vertex's degree.  ELL (not CSR) is the
TPU-native layout: every row has identical width so neighbor gathers become
dense strided loads on the VPU (see DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses

import numpy as np

SENTINEL = -1


@dataclasses.dataclass(frozen=True)
class Graph:
    """Host-side undirected graph in CSR form."""

    n: int                 # number of vertices
    offsets: np.ndarray    # (n+1,) int64 CSR row offsets
    targets: np.ndarray    # (m,)   int32 neighbor ids (symmetric: m = 2 * #edges)
    name: str = "graph"

    @property
    def num_edges(self) -> int:
        """Number of undirected edges."""
        return int(self.targets.shape[0]) // 2

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int32)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max()) if self.n else 0

    @property
    def avg_degree(self) -> float:
        return float(self.targets.shape[0]) / max(self.n, 1)

    def neighbors(self, v: int) -> np.ndarray:
        return self.targets[self.offsets[v] : self.offsets[v + 1]]


def symmetrize_edges(src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Return the symmetric closure of an edge list."""
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    return s, d


def build_graph(
    src: np.ndarray,
    dst: np.ndarray,
    n: int | None = None,
    *,
    symmetrize: bool = True,
    name: str = "graph",
) -> Graph:
    """Build a clean CSR graph from an edge list.

    Removes self-loops and multi-edges (paper Table 1 preprocessing).
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if n is None:
        n = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
    if symmetrize:
        src, dst = symmetrize_edges(src, dst)
    # Drop self loops.
    keep = src != dst
    src, dst = src[keep], dst[keep]
    # Dedup multi-edges via the linearized key.
    key = src * np.int64(n) + dst
    key = np.unique(key)
    src = (key // n).astype(np.int64)
    dst = (key % n).astype(np.int32)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.add.at(offsets, src + 1, 1)
    offsets = np.cumsum(offsets)
    # `key` is sorted by (src, dst) so dst is already grouped per row.
    return Graph(n=n, offsets=offsets, targets=dst, name=name)


def to_ell(
    graph: Graph,
    width: int | None = None,
    *,
    rows: np.ndarray | None = None,
) -> np.ndarray:
    """Export CSR rows to an ELL-padded (len(rows), width) int32 array.

    ``rows`` defaults to all vertices.  Entries past a row's degree hold
    ``SENTINEL``.  ``width`` defaults to the max degree over ``rows``.
    """
    if rows is None:
        rows = np.arange(graph.n, dtype=np.int64)
    rows = np.asarray(rows, dtype=np.int64)
    degs = (graph.offsets[rows + 1] - graph.offsets[rows]).astype(np.int64)
    if width is None:
        width = int(degs.max(initial=0))
    if len(rows) == 0 or width == 0 or graph.targets.shape[0] == 0:
        return np.full((len(rows), max(width, 0)), SENTINEL, dtype=np.int32)
    lane = np.arange(width, dtype=np.int64)[None, :]
    idx = graph.offsets[rows][:, None] + lane
    valid = lane < degs[:, None]
    m = graph.targets.shape[0]
    gathered = graph.targets[np.clip(idx, 0, max(m - 1, 0))]
    return np.where(valid, gathered, SENTINEL).astype(np.int32)


def ell_degrees(ell: np.ndarray) -> np.ndarray:
    """Degrees implied by an ELL block (sentinel-aware)."""
    return (ell != SENTINEL).sum(axis=1).astype(np.int32)


def induced_subgraph_ell(graph: Graph, rows: np.ndarray, width: int) -> np.ndarray:
    """ELL rows truncated/padded to ``width`` (used for bounded-degree tiles)."""
    return to_ell(graph, width=width, rows=rows)
