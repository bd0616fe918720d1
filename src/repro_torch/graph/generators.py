"""Synthetic generators matching the paper's graph suite (Table 1).

The paper's inputs come from SuiteSparse; this container has no network, so
each *class* of input gets a faithful synthetic analogue:

| Paper class              | Generator here            |
|--------------------------|---------------------------|
| PDE problems (ldoor, ...)| ``hex_mesh`` / ``grid_2d``|
| weak-scaling hexahedral  | ``hex_mesh`` (slab-ready) |
| synthetic rgg_n_2_24     | ``random_geometric``      |
| kron_g500-logn21         | ``rmat``                  |
| social networks          | ``rmat`` (skewed a/b/c/d) |
| mycielskian19/20         | ``mycielskian``           |
| road networks            | ``grid_2d`` (sparse, low deg) |
| PD2 bipartite inputs     | ``bipartite_random``      |

All generators are deterministic given ``seed``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import Graph, build_graph


def hex_mesh(nx: int, ny: int, nz: int, *, name: str | None = None) -> Graph:
    """Uniform 3D hexahedral mesh: 6-point stencil (paper's weak-scaling input).

    Vertices are cells of an ``nx × ny × nz`` grid; neighbors along ±x, ±y,
    ±z.  Matches the paper's "avg degree 6, max degree 6" hexahedral inputs.
    Vertex ids are x-major so 1D block partitioning yields the paper's
    "slab" decomposition along the x axis.

    The CSR is written directly, each row's neighbors in ascending order
    (-x, -y, -z, +z, +y, +x): the same graph ``build_graph`` makes from the
    edge list, without its sort over every edge.
    """
    n = nx * ny * nz
    x = np.arange(nx)[:, None, None]
    y = np.arange(ny)[None, :, None]
    z = np.arange(nz)[None, None, :]
    steps = ((x > 0, -ny * nz), (y > 0, -nz), (z > 0, -1),
             (z < nz - 1, 1), (y < ny - 1, nz), (x < nx - 1, ny * nz))
    mask = np.empty((nx, ny, nz, len(steps)), dtype=bool)
    for k, (m, _) in enumerate(steps):
        mask[..., k] = m
    mask = mask.reshape(n, len(steps))
    cand = (np.arange(n, dtype=np.int32)[:, None]
            + np.array([d for _, d in steps], dtype=np.int32))
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(mask.sum(axis=1), out=offsets[1:])
    return Graph(n=n, offsets=offsets, targets=cand[mask],
                 name=name or f"hex_{nx}x{ny}x{nz}")


def grid_2d(nx: int, ny: int, *, name: str | None = None) -> Graph:
    """2D grid (road-network-like: avg degree ~2-4, tiny max degree)."""
    n = nx * ny
    ids = np.arange(n, dtype=np.int64)
    x, y = ids // ny, ids % ny
    src = np.concatenate([ids[x < nx - 1], ids[y < ny - 1]])
    dst = np.concatenate([ids[x < nx - 1] + ny, ids[y < ny - 1] + 1])
    return build_graph(src, dst, n, name=name or f"grid_{nx}x{ny}")


def random_geometric(n: int, radius: float, *, seed: int = 0, name: str | None = None) -> Graph:
    """Random geometric graph in the unit square (rgg_n_2_* analogue).

    Grid-bucketed O(n) neighbor search; degrees concentrate near
    ``n * pi * r^2``.
    """
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    ncell = max(int(1.0 / radius), 1)
    cell = (pts * ncell).astype(np.int64)
    cell_id = cell[:, 0] * ncell + cell[:, 1]
    order = np.argsort(cell_id, kind="stable")
    srcs, dsts = [], []
    # Bucket boundaries.
    sorted_cells = cell_id[order]
    starts = np.searchsorted(sorted_cells, np.arange(ncell * ncell))
    ends = np.searchsorted(sorted_cells, np.arange(ncell * ncell), side="right")
    r2 = radius * radius
    for cx in range(ncell):
        for cy in range(ncell):
            me = order[starts[cx * ncell + cy] : ends[cx * ncell + cy]]
            if len(me) == 0:
                continue
            cand = [me]
            for dx, dy in ((0, 1), (1, -1), (1, 0), (1, 1)):
                ox, oy = cx + dx, cy + dy
                if 0 <= ox < ncell and 0 <= oy < ncell:
                    cand.append(order[starts[ox * ncell + oy] : ends[ox * ncell + oy]])
            others = np.concatenate(cand)
            d2 = ((pts[me, None, :] - pts[None, others, :]) ** 2).sum(-1)
            ii, jj = np.nonzero(d2 <= r2)
            u, v = me[ii], others[jj]
            keep = u < v
            srcs.append(u[keep])
            dsts.append(v[keep])
    src = np.concatenate(srcs) if srcs else np.empty(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.empty(0, np.int64)
    return build_graph(src, dst, n, name=name or f"rgg_{n}")


def rmat(
    scale: int,
    edge_factor: int = 16,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    name: str | None = None,
) -> Graph:
    """RMAT / Kronecker generator (kron_g500 + social-network analogue).

    Graph500 parameters by default -> heavy degree skew like twitter7 /
    com-Friendster at small scale.
    """
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        r = rng.random(m)
        # Quadrant probabilities: a | b / c | d.
        go_right = r >= a + c          # dst high bit
        go_down = ((r >= a) & (r < a + c)) | (r >= a + b + c)  # src high bit
        src |= go_down.astype(np.int64) << bit
        dst |= go_right.astype(np.int64) << bit
    # Permute vertex ids to remove locality artifacts.
    perm = rng.permutation(n)
    return build_graph(perm[src], perm[dst], n, name=name or f"rmat_{scale}")


def erdos_renyi(n: int, avg_degree: float, *, seed: int = 0, name: str | None = None) -> Graph:
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree / 2)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    return build_graph(src, dst, n, name=name or f"er_{n}")


def mycielskian(k: int, *, name: str | None = None) -> Graph:
    """Mycielskian M_k: triangle-free with chromatic number k (paper §5.2).

    M_2 = K2; M_{i+1} = Mycielski construction on M_i.  Sizes grow as
    3 * 2^(k-2) - 1, so mycielskian of order ~12-14 is the CPU-scale
    analogue of the paper's mycielskian19/20 stress inputs.
    """
    # Start with K2.
    edges = {(0, 1)}
    n = 2
    for _ in range(k - 2):
        # Vertices: 0..n-1 original, n..2n-1 copies (u_i), 2n apex (w).
        new_edges = set(edges)
        for (u, v) in edges:
            new_edges.add((u, v + n))
            new_edges.add((v, u + n))
        for i in range(n):
            new_edges.add((i + n, 2 * n))
        edges = new_edges
        n = 2 * n + 1
    src = np.array([e[0] for e in edges], dtype=np.int64)
    dst = np.array([e[1] for e in edges], dtype=np.int64)
    return build_graph(src, dst, n, name=name or f"mycielskian{k}")


def bipartite_random(
    n_rows: int,
    n_cols: int,
    nnz_per_row: int,
    *,
    seed: int = 0,
    name: str | None = None,
) -> Graph:
    """Bipartite graph B(Vs, Vt) as used for PD2 / Jacobian coloring (§3.6).

    Vertices 0..n_rows-1 are V_s (colored set), n_rows..n_rows+n_cols-1 are
    V_t.  Returned as a plain undirected graph over the union, matching the
    paper's PD2 implementation which colors the full bipartite representation.
    """
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n_rows, dtype=np.int64), nnz_per_row)
    dst = n_rows + rng.integers(0, n_cols, n_rows * nnz_per_row)
    return build_graph(src, dst, n_rows + n_cols, name=name or f"bip_{n_rows}x{n_cols}")


# ---------------------------------------------------------------------------
# The benchmark suite (CPU-scale analogue of paper Table 1).
# ---------------------------------------------------------------------------

def paper_suite(scale: str = "small") -> list[Graph]:
    """Graph suite mirroring Table 1 classes at container-feasible sizes."""
    if scale == "tiny":  # for tests
        return [
            hex_mesh(8, 8, 8, name="hex_tiny"),
            grid_2d(32, 32, name="road_tiny"),
            rmat(8, 8, seed=1, name="social_tiny"),
            random_geometric(512, 0.06, seed=2, name="rgg_tiny"),
            mycielskian(7, name="myc_tiny"),
        ]
    if scale == "small":
        return [
            hex_mesh(24, 24, 24, name="hex_pde"),        # PDE-problem analogue
            grid_2d(160, 160, name="road"),               # europe_osm analogue
            rmat(13, 16, seed=1, name="social_rmat"),     # soc-LiveJournal analogue
            rmat(12, 32, seed=3, name="web_rmat"),        # indochina analogue (denser)
            random_geometric(20000, 0.012, seed=2, name="rgg"),
            mycielskian(11, name="mycielskian11"),        # chromatic stress
            erdos_renyi(16384, 24.0, seed=4, name="er"),
        ]
    raise ValueError(f"unknown scale: {scale}")
