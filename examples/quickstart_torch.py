"""Quickstart on the PyTorch/CUDA port: distributed-color a graph, validate,
and inspect the result (the counterpart of ``examples/quickstart.py``).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
(``cuda`` by default: every part stacked on one card, the ``simulate``
engine; on the CPU the kernels' plain versions run.)
"""
import argparse

from repro_torch.core import (
    color_distributed,
    greedy_d1,
    is_proper_d1,
    num_colors,
)
from repro_torch.graph.generators import hex_mesh, rmat
from repro_torch.graph.partition import partition_graph


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = ap.parse_args(argv).device

    # 1. A PDE-style hexahedral mesh (the paper's weak-scaling input family).
    g = hex_mesh(16, 12, 12)
    print(f"graph {g.name}: {g.n} vertices, {g.num_edges} edges, maxdeg {g.max_degree}")

    # 2. Partition into 8 slabs with one ghost layer (paper §2.4).
    pg = partition_graph(g, 8)
    print(f"partitioned: {pg.n_parts} parts × {pg.n_local} vertices, "
          f"{pg.n_ghost} ghost slots, halo-able: {pg.halo_neighbors_ok()}")

    # 3. Distributed D1 with the paper's recolorDegrees heuristic (Alg. 2+4).
    res = color_distributed(pg, problem="d1", recolor_degrees=True, device=dev)
    assert res.converged and is_proper_d1(g, res.colors)
    print(f"D1: {res.n_colors} colors in {res.rounds} rounds "
          f"({res.comm_bytes_per_round} B/round/device)")

    # 4. Compare with serial greedy (Alg. 1) — the quality reference.
    greedy = num_colors(greedy_d1(g))
    print(f"serial greedy: {greedy} colors")

    # 5. Skewed social-network analogue: recolorDegrees pays off (§3.3).
    s = rmat(10, 8, seed=1)
    pgs = partition_graph(s, 8, strategy="edge_balanced")
    with_rd = color_distributed(pgs, problem="d1", recolor_degrees=True, device=dev)
    without = color_distributed(pgs, problem="d1", recolor_degrees=False, device=dev)
    print(f"rmat: recolorDegrees {with_rd.n_colors} colors "
          f"vs baseline {without.n_colors} colors")

    # 6. Swap the exchange strategy: `delta` ships only boundary colors that
    #    changed since the last round; the measured per-round payload shows
    #    the communication-reduction trajectory (identical coloring).
    delta = color_distributed(pg, problem="d1", exchange="delta", device=dev)
    assert (delta.colors == res.colors).all() and delta.rounds == res.rounds
    print(f"delta exchange: {[int(b) for b in delta.comm_bytes_by_round]} B/round "
          f"vs all_gather {[int(b) for b in res.comm_bytes_by_round]} B/round")

    # 7. Swap the compute backend: the hand-written CUDA kernels (one
    #    fused_round launch a round; their plain versions on the CPU)
    #    produce the identical coloring in the identical round count.
    fused = color_distributed(pg, problem="d1", backend="cuda_fused", device=dev)
    assert (fused.colors == res.colors).all() and fused.rounds == res.rounds
    print(f"cuda_fused backend: {fused.n_colors} colors in {fused.rounds} rounds "
          f"(backend={fused.backend}, exchange={fused.exchange})")
    return {"d1": res, "greedy": greedy, "rmat": (with_rd, without), "delta": delta,
            "cuda_fused": fused}


if __name__ == "__main__":
    main()
