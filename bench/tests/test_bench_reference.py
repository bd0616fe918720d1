"""The port's results equal the benchmark's plain reference, field by field,
over several seeds: cold distance-1 and distance-2 colorings and the
timestep mix's recolorings.  The port runs on the CPU (the kernels' plain
versions), as ``bench/kinds/coloring.py`` builds it."""
import numpy as np
import pytest

import torch

from bench.gen import hex_mesh
from bench.kinds.coloring import make_inputs
from bench.reference.coloring import Topology
from repro_torch.core.plan import PlanCache, get_plan
from repro_torch.graph.partition import partition_graph

CASES = [("d1", (16, 8, 8), 8), ("d1", (12, 6, 10), 4), ("d2", (16, 8, 8), 8),
         ("d2", (8, 10, 6), 4)]


def _same(res, ref):
    assert np.array_equal(res.colors, ref.colors)
    assert (res.rounds, res.converged, res.total_conflicts, res.n_colors) == (
        ref.rounds, ref.converged, ref.total_conflicts, ref.n_colors)
    assert np.array_equal(res.comm_bytes_by_round, ref.bytes_by_round)


@pytest.mark.parametrize("backend", ["cuda_fused", "reference"])
@pytest.mark.parametrize("problem,dims,parts", CASES)
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_port_equals_reference(problem, dims, parts, seed, backend):
    config = {"graph": {"generator": "hex_mesh", "dims": dims}, "n_parts": parts}
    ell, graph = make_inputs(config, seed, "cpu")
    two = problem == "d2"
    pg = partition_graph(graph, parts, second_layer=two)
    plan = get_plan(pg, problem=problem, backend=backend, exchange="sparse_delta",
                    engine="simulate", device="cpu", cache=PlanCache())
    topo = Topology(ell, parts, problem, second_layer=two)
    cold, ref = plan.run(), topo.color()
    _same(cold, ref)
    assert topo.improper(cold.colors) == 0 and ref.total_conflicts > 0
    rng = np.random.default_rng(seed)
    prev = cold
    for _ in range(3):                      # the timestep mix: 10% from the last
        mask = rng.random(ell.shape[0]) < 0.1
        colors0 = np.where(mask, 0, prev.colors).astype(np.int32)
        prev = plan.run(color_mask=mask, colors0=colors0)
        _same(prev, topo.color(colors0, mask))


def test_renumbering_keeps_the_slabs_and_the_graph():
    ell = hex_mesh.make({"dims": (8, 4, 6)}, 4, 3).numpy()
    base = hex_mesh.hex_mesh_ell(8, 4, 6).numpy()
    n = ell.shape[0]
    slab = np.searchsorted(hex_mesh.slab_bounds(n, 4), np.arange(n), side="right") - 1

    def edges(e):
        src = np.repeat(np.arange(n), e.shape[1])[e.reshape(-1) >= 0]
        return src, e.reshape(-1)[e.reshape(-1) >= 0]

    src, dst = edges(ell)
    assert set(zip(src.tolist(), dst.tolist())) == set(zip(dst.tolist(), src.tolist()))
    assert not (src == dst).any()
    # Each slab keeps its degrees, and cross-slab edges join the same slabs.
    deg, deg0 = (ell >= 0).sum(1), (base >= 0).sum(1)
    for s in range(4):
        assert sorted(deg[slab == s]) == sorted(deg0[slab == s])
    src0, dst0 = edges(base)
    assert sorted(zip(slab[src], slab[dst])) == sorted(zip(slab[src0], slab[dst0]))
    assert not torch.equal(hex_mesh.make({"dims": (8, 4, 6)}, 4, 3),
                           hex_mesh.make({"dims": (8, 4, 6)}, 4, 4))
