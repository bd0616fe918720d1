"""Application on the PyTorch/CUDA port: PD2 coloring for sparse-Jacobian
compression (paper §1/§3.6; the counterpart of ``examples/color_jacobian.py``).

The classic use of partial distance-2 coloring: columns of a sparse
Jacobian J that share no row can be evaluated with ONE forward difference.
We color the bipartite row-column graph with the paper's distributed PD2,
then verify the compression is lossless: seed-matrix probing recovers
every nonzero of J exactly.

Run:  PYTHONPATH=src python examples/color_jacobian_torch.py [--device cpu]
(``cuda`` by default.)
"""
import argparse

import numpy as np

from repro_torch.core import color_distributed, is_proper_pd2
from repro_torch.graph.csr import build_graph
from repro_torch.graph.partition import partition_graph


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = ap.parse_args(argv).device
    rng = np.random.default_rng(0)

    # 1. A sparse Jacobian pattern: 400 outputs × 300 inputs, ~4 nnz per row.
    n_rows, n_cols, nnz_per_row = 400, 300, 4
    rows = np.repeat(np.arange(n_rows), nnz_per_row)
    cols = rng.integers(0, n_cols, n_rows * nnz_per_row)
    J = np.zeros((n_rows, n_cols))
    J[rows, cols] = rng.standard_normal(len(rows))

    # 2. Bipartite graph: rows = 0..n_rows-1, columns = n_rows..n_rows+n_cols-1.
    g = build_graph(rows.astype(np.int64), (n_rows + cols).astype(np.int64),
                    n_rows + n_cols, name="jacobian")

    # 3. Distributed PD2 over 4 parts (columns that share a row get different
    #    colors — exactly the paper's "what color is your Jacobian" use case).
    pg = partition_graph(g, 4, strategy="edge_balanced", second_layer=True)
    res = color_distributed(pg, problem="pd2", device=dev)
    assert res.converged and is_proper_pd2(g, res.colors)
    col_colors = res.colors[n_rows:]
    groups = np.unique(col_colors)
    print(f"PD2: {len(groups)} colors for {n_cols} columns "
          f"(compression {n_cols / len(groups):.1f}x, rounds={res.rounds})")

    # 4. Verify losslessness: probe J with one seed vector per color and
    #    recover every entry.
    recovered = np.zeros_like(J)
    for c in groups:
        seed = (col_colors == c).astype(float)           # sum of columns in group
        probe = J @ seed                                  # one J·v evaluation
        for j in np.nonzero(col_colors == c)[0]:
            rows_j = np.nonzero(J[:, j])[0]
            recovered[rows_j, j] = probe[rows_j]
    np.testing.assert_allclose(recovered, J, atol=1e-12)
    print(f"recovered all {int((J != 0).sum())} nonzeros from "
          f"{len(groups)} J·v products instead of {n_cols} ✓")
    return {"pd2": res, "J": J, "recovered": recovered, "groups": groups}


if __name__ == "__main__":
    main()
