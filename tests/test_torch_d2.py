"""The port's distance-2 slice against ``repro``: kernels, local coloring,
``d1_2gl``/``d2``/``pd2`` end to end, and the two-hop validators.

Integer math, so every comparison is exact equality.  Inputs are made
with numpy from a seed and handed to both packages; ``repro``'s Pallas
kernels run in interpret mode.  On the CPU the port's kernel wrappers take
their plain versions; ``test_torch_kernels_card.py`` holds the CUDA
kernels to those on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as j_dist
from repro.core import local as j_local
from repro.core import validate as j_validate
from repro.core.greedy import greedy_d2, greedy_pd2
from repro.core.plan import build_plan as j_build_plan
from repro.graph import generators as j_gen
from repro.graph.partition import partition_graph as j_partition
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.core import distributed as t_dist
from repro_torch.core import local as t_local
from repro_torch.core import validate as t_validate
from repro_torch.core.plan import ColoringPlan
from repro_torch.graph import generators as t_gen
from repro_torch.graph.partition import partition_graph as t_partition
from repro_torch.kernels._testing import D2_SHAPES, random_ext, random_stacked
from repro_torch.kernels.d2_forbidden import d2_assign, d2_assign_ref, d2_forbidden_ref
from repro_torch.kernels.ops import local_color_d2_cuda
from test_torch_distributed import assert_same_result
from test_torch_kernels_card import _t

BACKENDS = ("reference", "cuda", "cuda_fused")
# The graphs of tests/test_coloring.py::GRAPHS, and its pd2 Jacobian graph.
GRAPHS = {
    "hex": ("hex_mesh", (8, 6, 6), {}),
    "grid": ("grid_2d", (20, 20), {}),
    "rmat": ("rmat", (8, 6), {"seed": 3}),
    "myc": ("mycielskian", (8,), {}),
}
BIPARTITE = ("bipartite_random", (120, 60, 3), {"seed": 2})
# d2 end to end: the mesh graphs, and a smaller skewed rmat in place of
# rmat(8, 6) and mycielskian(8), whose two-hop blocks (95-110 lanes wide,
# about 10^4 two-hop lanes a row) take about 30 s a run in repro alone.
D2_GRAPHS = {"hex": GRAPHS["hex"], "grid": GRAPHS["grid"],
             "rmat": ("rmat", (6, 3), {"seed": 3})}


def _graphs(spec):
    fn, args, kw = spec
    return getattr(j_gen, fn)(*args, **kw), getattr(t_gen, fn)(*args, **kw)


def _d2_inputs(n, w, g, parts):
    """The sweep inputs of tests/test_kernels.py::test_d2_forbidden_sweep for
    part 0, drawn per part and stacked."""
    per, (adj, tab, base, active, *_) = random_stacked(n, w, g, 20, n * 7, parts)
    return per, adj, tab, base, active, random_ext(n, w, g, n, parts)


@pytest.mark.parametrize("n,w,g", D2_SHAPES)
@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("partial_d2", [False, True])
def test_d2_forbidden_plain_matches_pallas_and_ref(n, w, g, parts, partial_d2):
    per, adj, tab, base, active, ext = _d2_inputs(n, w, g, parts)
    got = d2_forbidden_ref(*_t(adj, base, active, tab[:, :n].copy(), tab, ext),
                           partial_d2=partial_d2)
    assert got.dtype == torch.int64 and int(got.max()) < 2**32
    for p, (a, t, b, ac, *_) in enumerate(per):
        args = tuple(map(jnp.asarray, (a, b, ac, t[:n], t, ext[p])))
        for fn in (j_ops.d2_forbidden, j_ref.d2_forbidden_ref):
            want = np.asarray(fn(*args, partial_d2=partial_d2)).astype(np.int64)
            np.testing.assert_array_equal(got[p].numpy(), want)


@pytest.mark.parametrize("n,w,g", D2_SHAPES)
@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("partial_d2", [False, True])
def test_d2_assign_plain_matches_pallas(n, w, g, parts, partial_d2):
    """``d2_assign`` over the list of active uncolored rows, on a ``newc``
    that starts as the rows' colors, equals ``d2_assign_ref`` over every
    row, and both equal ``d2_assign_pallas``."""
    per, adj, tab, base, active, ext = _d2_inputs(n, w, g, parts)
    args = _t(adj, ext, tab, base, active)
    rows = torch.from_numpy(np.flatnonzero(active & (tab[:, :n] == 0)).astype(np.int32))
    got = d2_assign(*_t(adj, ext, tab, base.copy(), tab[:, :n].copy()), rows,
                    partial_d2=partial_d2)
    for a, b in zip(got, d2_assign_ref(*args, partial_d2=partial_d2)):
        assert torch.equal(a, b) and a.dtype == torch.int32
    for p, (a, t, b, ac, *_) in enumerate(per):
        want = j_ops.d2_assign_pallas(
            *map(jnp.asarray, (a, ext[p], t, b, ac)), partial_d2=partial_d2)
        np.testing.assert_array_equal(got[0][p].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1][p].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("partial_d2", [False, True])
def test_local_color_d2_matches_jax(partial_d2):
    """Both of the port's d2 fixed points equal JAX's ``local_color_d2`` on
    every part of ``rmat(7, 5, seed=11)`` over 2 parts."""
    pg = j_partition(j_gen.rmat(7, 5, seed=11), 2, second_layer=True)
    st = j_dist.build_device_state(pg, "d2")
    tab0 = np.zeros((2, pg.n_local + pg.n_ghost + 1), np.int32)
    adj, th, ext, act, deg, gid = _t(st["adj_cidx"], st["two_hop_cidx"],
                                     st["ext_adj_cidx"], st["active0"],
                                     st["deg_tab"], st["gid_tab"])
    np.testing.assert_array_equal(t_local.build_two_hop(adj, ext).numpy(),
                                  st["two_hop_cidx"])
    kw = dict(partial_d2=partial_d2)
    plain = t_local.local_color_d2(adj, th, torch.from_numpy(tab0), act, deg, gid, **kw)
    kern = local_color_d2_cuda(adj, th, ext, torch.from_numpy(tab0), act, deg, gid, **kw)
    assert t_local.MAX_ITERS_D2 == 1024
    for p in range(2):
        want = j_local.local_color_d2(
            *(jnp.asarray(st[k][p]) for k in ("adj_cidx", "two_hop_cidx")),
            jnp.asarray(tab0[p]),
            *(jnp.asarray(st[k][p]) for k in ("active0", "deg_tab", "gid_tab")), **kw)
        np.testing.assert_array_equal(plain[p].numpy(), np.asarray(want))
        np.testing.assert_array_equal(kern[p].numpy(), np.asarray(want))
    assert (plain[:, :pg.n_local][st["active0"]] > 0).all()


@pytest.mark.parametrize("gname", list(D2_GRAPHS))
@pytest.mark.parametrize("parts", [1, 3, 8])
def test_d2_matches_simulate(gname, parts):
    jg, tg = _graphs(D2_GRAPHS[gname])
    kw = dict(strategy="edge_balanced", second_layer=True)
    jpg, tpg = j_partition(jg, parts, **kw), t_partition(tg, parts, **kw)
    want = j_dist.color_distributed(jpg, problem="d2", engine="simulate",
                                    exchange="all_gather", cache=False)
    for backend in BACKENDS:
        got = t_dist.color_distributed(tpg, problem="d2", backend=backend,
                                       device="cpu")
        assert (got.backend, got.problem) == (backend, "d2")
        assert_same_result(got, want)
        assert got.converged and t_validate.is_proper_d2(tg, got.colors)


@pytest.mark.parametrize("parts", [1, 3, 8])
def test_pd2_matches_simulate(parts):
    jg, tg = _graphs(BIPARTITE)
    jpg = j_partition(jg, parts, second_layer=True)
    tpg = t_partition(tg, parts, second_layer=True)
    want = j_dist.color_distributed(jpg, problem="pd2", engine="simulate", cache=False)
    for backend in BACKENDS:
        got = t_dist.color_distributed(tpg, problem="pd2", backend=backend,
                                       device="cpu")
        assert_same_result(got, want)
        assert got.converged and t_validate.is_proper_pd2(tg, got.colors)


@pytest.mark.parametrize("problem", ["d2", "pd2"])
def test_d2_warm_requests_match(problem):
    """Warm requests through one plan (the timestep workload) equal JAX's."""
    jg, tg = _graphs(BIPARTITE if problem == "pd2" else D2_GRAPHS["rmat"])
    jpg = j_partition(jg, 3, second_layer=True)
    tpg = t_partition(tg, 3, second_layer=True)
    jplan = j_build_plan(jpg, problem=problem, engine="simulate", state_cache=False)
    plans = [ColoringPlan(tpg, problem=problem, backend=b, device="cpu")
             for b in BACKENDS]
    prev = jplan.run()
    for plan in plans:
        assert_same_result(plan.run(), prev)
    rng = np.random.default_rng(4)
    mask = rng.random(jg.n) < 0.1
    colors0 = prev.colors.copy()
    colors0[mask] = 0
    want = jplan.run(color_mask=mask, colors0=colors0)
    for plan in plans:
        assert_same_result(plan.run(color_mask=mask, colors0=colors0), want)


def test_plan_refuses_bad_problems():
    _, tg = _graphs(GRAPHS["hex"])
    with pytest.raises(ValueError, match="second_layer=True"):
        ColoringPlan(t_partition(tg, 3), problem="d2", device="cpu")
    with pytest.raises(ValueError, match="problem must be one of"):
        ColoringPlan(t_partition(tg, 3), problem="d3", device="cpu")


def _crafted(g, colors, problem):
    """An improper copy of a proper coloring: two vertices that share a
    neighbor get one color (both problems), or, for d2, two adjacent ones."""
    out = colors.copy()
    u = int(np.argmax(np.diff(g.offsets)))          # a vertex with neighbors
    nbrs = g.targets[g.offsets[u]:g.offsets[u + 1]]
    if problem == "pd2":
        out[nbrs[1]] = out[nbrs[0]]
    else:
        out[u] = out[nbrs[0]]
    return out


@pytest.mark.parametrize("gname", list(GRAPHS) + ["bip"])
def test_validators_match_on_proper_and_crafted(gname):
    jg, tg = _graphs(BIPARTITE if gname == "bip" else GRAPHS[gname])
    for problem, greedy in (("d2", greedy_d2), ("pd2", greedy_pd2)):
        name = f"is_proper_{problem}"
        proper = greedy(jg)
        partly = proper.copy()
        partly[::7] = 0                              # uncolored vertices
        for colors in (proper, _crafted(jg, proper, problem), partly):
            for complete in (True, False):
                want = getattr(j_validate, name)(jg, colors,
                                                 require_complete=complete)
                assert getattr(t_validate, name)(
                    tg, colors, require_complete=complete) == want
        assert getattr(t_validate, name)(tg, proper)
        assert not getattr(t_validate, name)(tg, _crafted(jg, proper, problem))
