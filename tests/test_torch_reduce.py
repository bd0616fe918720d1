"""The port's color reduction against ``repro``'s: every pass's colors and
accounting equal, the strict-reduction pins, never-increase and
properness, every order, masks, and the plan-cache entries.

The counterparts of ``tests/test_reduce.py``.  Both packages reduce the
same coloring of the same ``PartitionedGraph``; the port runs on the CPU.
"""
import numpy as np
import pytest
import torch

from repro.core import reduce as j_reduce
from repro.core.plan import PlanCache as JPlanCache
from repro.core.plan import get_plan as j_get_plan
from repro.graph import generators as j_gen
from repro.graph.partition import partition_graph as j_partition
from repro_torch.core.distributed import color_distributed
from repro_torch.core.exchange import EXCHANGES
from repro_torch.core.greedy import greedy_d1
from repro_torch.core.plan import PlanCache, PlanKey, build_plan, get_plan
from repro_torch.core.reduce import (
    ORDERS,
    ReduceKey,
    ReductionPlan,
    _cap_for,
    get_order,
    get_reduce_plan,
    reduce_colors,
    reduce_colors_batch,
    register_order,
)
from repro_torch.core.validate import is_proper_d1, is_proper_d2, is_proper_pd2, num_colors
from repro_torch.graph import generators as t_gen
from repro_torch.graph.partition import partition_graph as t_partition

CPU = dict(device="cpu")
VALIDATORS = {"d1": is_proper_d1, "d2": is_proper_d2, "pd2": is_proper_pd2}
RESULT_FIELDS = ("n_colors", "initial_n_colors", "improved", "passes_run",
                 "colors_by_pass", "comm_bytes_by_pass", "rounds_by_pass",
                 "exchanges_by_pass", "converged", "order", "problem")
_CACHE = PlanCache(maxsize=64)
_J_CACHE = JPlanCache(maxsize=64)


def _pgs(fn, args, kw, parts, strategy="block", second_layer=False):
    jg, tg = getattr(j_gen, fn)(*args, **kw), getattr(t_gen, fn)(*args, **kw)
    return (jg, j_partition(jg, parts, strategy=strategy, second_layer=second_layer),
            tg, t_partition(tg, parts, strategy=strategy, second_layer=second_layer))


_, J_PG, GRAPH, PG = _pgs("hex_mesh", (6, 4, 4), {}, 3, second_layer=True)


def assert_same_reduction(got, want):
    np.testing.assert_array_equal(got.colors, want.colors)
    for f in RESULT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.comm_bytes_total == want.comm_bytes_total


def _plans(jpg, tpg, **kw):
    return (j_get_plan(jpg, engine="simulate", cache=_J_CACHE, **kw),
            get_plan(tpg, cache=_CACHE, **CPU, **kw))


# ---------------------------------------------------------------------------
# The chromatic number is a hard lower bound; pins that strictly improve.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [5, 7])
def test_mycielskian_chromatic_lower_bound(k):
    _, jpg, g, pg = _pgs("mycielskian", (k,), {}, 3, strategy="edge_balanced")
    assert num_colors(greedy_d1(g)) >= k
    jplan, plan = _plans(jpg, pg)
    res = color_distributed(pg, cache=_CACHE, **CPU)
    assert is_proper_d1(g, res.colors) and res.n_colors >= k
    red = reduce_colors(pg, res, passes=3, cache=_CACHE, **CPU)
    assert is_proper_d1(g, red.colors) and red.n_colors >= k
    assert_same_reduction(red, j_reduce.reduce_colors(jplan, jplan.run(), passes=3,
                                                      cache=_J_CACHE))


@pytest.mark.parametrize("spec,parts,strategy", [
    (("rmat", (8, 8), {"seed": 1, "name": "social_tiny"}), 8, "random"),
    (("mycielskian", (9,), {}), 4, "edge_balanced"),
])
def test_reduce_strictly_improves_toy_inputs(spec, parts, strategy):
    _, jpg, g, pg = _pgs(*spec, parts, strategy=strategy)
    jplan, _ = _plans(jpg, pg)
    want = j_reduce.reduce_colors(jplan, jplan.run(), passes=2, cache=_J_CACHE)
    for backend in ("reference", "cuda_fused"):
        plan = get_plan(pg, backend=backend, cache=_CACHE, **CPU)
        res = plan.run()
        red = reduce_colors(plan, res, passes=2)
        assert is_proper_d1(g, red.colors), g.name
        assert red.improved and red.n_colors < res.n_colors, red.colors_by_pass
        assert red.colors_by_pass[0] == res.n_colors
        assert min(red.colors_by_pass) == red.n_colors
        assert all(b > 0 for b in red.comm_bytes_by_pass)
        assert red.comm_bytes_total == sum(red.comm_bytes_by_pass)
        assert_same_reduction(red, want)


# ---------------------------------------------------------------------------
# Never-increase + properness: problems x every registered exchange.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("problem", ["d1", "d2", "pd2"])
@pytest.mark.parametrize("exchange", sorted(EXCHANGES))
def test_reduce_proper_never_increases(problem, exchange):
    if exchange == "halo" and not PG.halo_neighbors_ok():
        pytest.skip("partition not slab-legal")
    jplan, plan = _plans(J_PG, PG, problem=problem, exchange=exchange)
    res = plan.run()
    red = reduce_colors(plan, res, passes=2)
    assert red.converged
    assert red.n_colors <= res.n_colors
    assert VALIDATORS[problem](GRAPH, red.colors), (problem, exchange)
    # Rebuilt classes are independent sets of the conflict graph: no
    # superstep needs a conflict-resolution round.
    assert all(r == 0 for r in red.rounds_by_pass), (problem, exchange)
    accepted = red.colors_by_pass[:-1]
    assert accepted == sorted(accepted, reverse=True)
    assert_same_reduction(red, j_reduce.reduce_colors(jplan, jplan.run(), passes=2,
                                                      cache=_J_CACHE))


@pytest.mark.parametrize("order", ["reverse", "largest_first", "least_used_first"])
@pytest.mark.parametrize("problem", ["d1", "d2"])
def test_reduce_every_order_matches(order, problem):
    jplan, plan = _plans(J_PG, PG, problem=problem)
    res = plan.run()
    red = reduce_colors(plan, res, passes=3, order=order)
    assert VALIDATORS[problem](GRAPH, red.colors), order
    assert red.n_colors <= res.n_colors, order
    assert red.order == order
    assert_same_reduction(red, j_reduce.reduce_colors(
        jplan, jplan.run(), passes=3, order=order, cache=_J_CACHE))


@pytest.mark.parametrize("order", ["reverse", "largest_first", "least_used_first"])
@pytest.mark.parametrize("sizes", [
    {1: 5, 2: 9, 3: 5, 4: 9, 5: 2, 6: 5, 8: 1},     # color 7 absent
    {c: 3 for c in range(1, 25)},                   # every class ties
], ids=["mixed", "all_tie"])
def test_select_ties_rank_as_repro(order, sizes):
    """Equal class sizes tie under largest_first / least_used_first: the
    lower color ranks first, exactly as jnp's stable argsort does."""
    rng = np.random.default_rng(3)
    colors = np.concatenate([np.full(s, c, np.int32) for c, s in sizes.items()]
                            + [np.zeros(4, np.int32)])
    colors = rng.permutation(colors)
    cap = _cap_for(int(colors.max()))
    want = j_reduce.get_reduce_plan(colors.size, cap, order, cache=False).select(colors)
    got = get_reduce_plan(colors.size, cap, order, cache=False, **CPU).select(colors)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == len(sizes)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[2].dtype == want[2].dtype == np.int32
    if order == "largest_first" and len(sizes) == 7:    # 9, 9 (2 then 4), 5, 5, 5
        assert [got[2][colors == c][0] for c in (2, 4, 1, 3, 6)] == [0, 1, 2, 3, 4]
    if order != "reverse" and len(sizes) == 24:          # ties: color order
        assert [got[2][colors == c][0] for c in sizes] == list(range(24))


# ---------------------------------------------------------------------------
# Warm-path contract and cache entries.
# ---------------------------------------------------------------------------

def test_warm_reduction_no_second_build():
    cache = PlanCache()
    plan = build_plan(PG, problem="d1", **CPU)
    res = plan.run()
    red1 = reduce_colors(plan, res, passes=2, cache=cache)
    rkeys = [k for k in cache.keys() if isinstance(k, ReduceKey)]
    assert len(rkeys) == 1 and rkeys[0].device == "cpu"
    rplan = cache._plans[rkeys[0]]
    assert isinstance(rplan, ReductionPlan) and rplan.stats.traces == 1
    assert rplan.stats.compiles == 1 and rplan.stats.selects >= 1
    red2 = reduce_colors(plan, res, passes=2, cache=cache)
    assert rplan.stats.traces == 1 and plan.stats.traces == 1
    assert rplan.stats.compiles == 1 and rplan.stats.reduce_ms > 0
    assert_same_reduction(red2, red1)
    assert cache.hits >= 1


def test_reduce_plan_cached_alongside_coloring_plans():
    cache = PlanCache()
    plan = get_plan(PG, problem="d1", cache=cache, **CPU)
    reduce_colors(plan, plan.run(), passes=1, cache=cache)
    assert {type(k) for k in cache.keys()} == {PlanKey, ReduceKey}
    rk = [k for k in cache.keys() if isinstance(k, ReduceKey)][0]
    assert get_reduce_plan(rk.n_global, rk.cap, rk.order, cache=cache, **CPU) \
        is cache._plans[rk]
    a = get_reduce_plan(rk.n_global, rk.cap, rk.order, cache=False, **CPU)
    b = get_reduce_plan(rk.n_global, rk.cap, rk.order, cache=False, **CPU)
    assert a is not b


def test_order_registry():
    with pytest.raises(ValueError, match="unknown order"):
        get_order("nope")
    plan = get_plan(PG, problem="d1", cache=_CACHE, **CPU)
    res = plan.run()
    with pytest.raises(ValueError, match="unknown order"):
        reduce_colors(plan, res, passes=1, order="nope")

    def natural(color, hist):                 # lowest colors rebuilt first
        del hist
        return -color.to(torch.float32)

    register_order("natural_test", natural)
    try:
        red = reduce_colors(plan, res, passes=2, order="natural_test",
                            cache=PlanCache())
        assert is_proper_d1(GRAPH, red.colors)
        assert red.n_colors <= res.n_colors
    finally:
        del ORDERS["natural_test"]


# ---------------------------------------------------------------------------
# Integration: color_distributed, masks, merged results, shapes.
# ---------------------------------------------------------------------------

def test_color_distributed_reduce_passes_folds_result():
    from repro.core.distributed import color_distributed as j_color

    base = color_distributed(PG, problem="d2", cache=_CACHE, **CPU)
    red = color_distributed(PG, problem="d2", cache=_CACHE, reduce_passes=2, **CPU)
    want = j_color(J_PG, problem="d2", engine="simulate", cache=_J_CACHE,
                   reduce_passes=2)
    assert is_proper_d2(GRAPH, red.colors)
    assert red.n_colors < base.n_colors
    assert red.comm_bytes_total > base.comm_bytes_total
    assert red.comm_bytes_by_round is None and red.comm_bytes_by_level is None
    assert 0 < red.comm_bytes_per_round <= red.comm_bytes_total
    assert red.converged
    np.testing.assert_array_equal(red.colors, want.colors)
    for f in ("n_colors", "rounds", "converged", "total_conflicts",
              "comm_bytes_total", "comm_bytes_per_round", "problem"):
        assert getattr(red, f) == getattr(want, f), f


def test_merged_result_matches_repro():
    jplan, plan = _plans(J_PG, PG, problem="d2", exchange="delta")
    jbase, base = jplan.run(), plan.run()
    got = reduce_colors(plan, base, passes=2).merged_result(base)
    want = j_reduce.reduce_colors(jplan, jbase, passes=2,
                                  cache=_J_CACHE).merged_result(jbase)
    np.testing.assert_array_equal(got.colors, want.colors)
    for f in ("n_colors", "rounds", "converged", "total_conflicts",
              "comm_bytes_total", "comm_bytes_per_round", "comm_bytes_by_round",
              "comm_bytes_by_level", "problem", "n_parts", "exchange"):
        assert getattr(got, f) == getattr(want, f), f


def test_masked_reduction_respects_frozen_vertices():
    _, jpg, g, pg = _pgs("rmat", (8, 8), {"seed": 1}, 8, strategy="random")
    jplan, plan = _plans(jpg, pg)
    base = plan.run()
    mask = np.arange(g.n) % 2 == 0                # dirty region
    frozen = ~mask
    red = reduce_colors(plan, base, passes=2, color_mask=mask, cache=_CACHE)
    assert (red.colors[frozen] == base.colors[frozen]).all()
    assert is_proper_d1(g, red.colors)
    assert red.n_colors <= base.n_colors
    assert_same_reduction(red, j_reduce.reduce_colors(
        jplan, jplan.run(), passes=2, color_mask=mask, cache=_J_CACHE))
    # The batch driver threads each element's own mask.
    batch = reduce_colors_batch(plan, [base, base], passes=2,
                                color_masks=[mask, None], cache=_CACHE)
    assert_same_reduction(batch[0], red)
    assert_same_reduction(batch[1], reduce_colors(plan, base, passes=2, cache=_CACHE))
    with pytest.raises(ValueError, match="color_mask"):
        reduce_colors(plan, base, passes=1, color_mask=np.ones(3, bool))
    with pytest.raises(ValueError, match="color_masks"):
        reduce_colors_batch(plan, [base], color_masks=[None, None])


def test_warm_start_sees_frozen_ghosts_round_zero():
    plan = get_plan(PG, problem="d1", cache=_CACHE, **CPU)
    base = plan.run()
    top = int(base.colors.max())
    mask = base.colors == top
    res = plan.run(color_mask=mask, colors0=np.where(mask, 0, base.colors))
    assert res.rounds == 0 and res.total_conflicts == 0
    assert (res.colors[~mask] == base.colors[~mask]).all()
    assert is_proper_d1(GRAPH, res.colors)
    assert (res.colors[mask] <= top).all()    # first-fit never climbs


def test_reduce_validates_colors_shape():
    plan = get_plan(PG, problem="d1", cache=_CACHE, **CPU)
    with pytest.raises(ValueError, match="n_global"):
        reduce_colors(plan, np.zeros(3, np.int32), passes=1)


def test_reduce_zero_passes_is_noop():
    plan = get_plan(PG, problem="d1", cache=_CACHE, **CPU)
    res = plan.run()
    red = reduce_colors(plan, res, passes=0)
    assert red.passes_run == 0 and not red.improved
    assert (red.colors == res.colors).all()
    assert red.colors_by_pass == [res.n_colors]
    assert red.merged_result(res).rounds == res.rounds
