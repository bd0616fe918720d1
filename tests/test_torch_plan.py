"""The port's plan layer against ``repro``'s: cache keying, LRU and byte
eviction, the warm-path contract, and plan runs equal to ``repro``'s.

The counterparts of ``tests/test_plan.py``'s plan tests.  Both packages
get the same ``PartitionedGraph``; ``repro`` runs its ``reference``
backend (pinned bit-identical to ``pallas`` by its own tests) and the
port's three backends run on the CPU, where the kernel wrappers take
their plain versions.  Results are compared for equality.
"""
import numpy as np
import pytest
import torch

from repro.core import distributed as j_dist
from repro.core import plan as j_plan
from repro.graph import generators as j_gen
from repro.graph.partition import partition_graph as j_partition
from repro_torch.core import plan as plan_mod
from repro_torch.core.distributed import color_distributed
from repro_torch.core.exchange import SparseDeltaExchange
from repro_torch.core.backend import CudaBackend
from repro_torch.core.plan import (
    ColoringPlan,
    PlanCache,
    PlanKey,
    build_plan,
    default_plan_cache,
    get_plan,
    plan_key_for,
)
from repro_torch.core.validate import is_proper_d1, is_proper_d2, is_proper_pd2
from repro_torch.graph.generators import hex_mesh
from repro_torch.graph.partition import partition_graph

GRAPH = hex_mesh(6, 4, 4)
PG = partition_graph(GRAPH, 3, strategy="block", second_layer=True)
J_PG = j_partition(j_gen.hex_mesh(6, 4, 4), 3, strategy="block", second_layer=True)
CPU = dict(device="cpu")
BACKENDS = ("reference", "cuda", "cuda_fused")
VALIDATORS = {"d1": is_proper_d1, "d1_2gl": is_proper_d1, "d2": is_proper_d2,
              "pd2": is_proper_pd2}
_J_CACHE = j_plan.PlanCache(maxsize=64)


def assert_same_result(got, want):
    np.testing.assert_array_equal(got.colors, want.colors)
    for f in ("rounds", "converged", "total_conflicts", "n_colors",
              "comm_bytes_per_round", "comm_bytes_total", "problem", "n_parts",
              "exchange"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("comm_bytes_by_round", "comm_bytes_by_level"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b)


def _repro_plan(**kw):
    return j_plan.get_plan(J_PG, engine="simulate", cache=_J_CACHE, **kw)


# ---------------------------------------------------------------------------
# Cache keying: every key component misses once, then hits.
# ---------------------------------------------------------------------------

def test_cache_hit_miss_on_every_key_component(monkeypatch):
    cache = PlanCache(maxsize=32)
    base = dict(problem="d1", recolor_degrees=True, backend="reference",
                exchange="all_gather", engine="simulate", max_rounds=64, **CPU)
    variants = [
        base,
        {**base, "problem": "d2"},
        {**base, "recolor_degrees": False},
        {**base, "backend": "cuda"},
        {**base, "backend": "cuda_fused"},
        {**base, "exchange": "delta"},
        {**base, "max_rounds": 32},
    ]
    for i, kw in enumerate(variants):
        plan = get_plan(PG, cache=cache, **kw)
        assert cache.misses == i + 1, kw
        assert get_plan(PG, cache=cache, **kw) is plan, kw
    assert cache.hits == len(variants)

    # Different topology -> miss; identical-content topology -> hit.
    other = partition_graph(GRAPH, 4, strategy="block", second_layer=True)
    get_plan(other, cache=cache, **base)
    assert cache.misses == len(variants) + 1
    clone = partition_graph(GRAPH, 3, strategy="block", second_layer=True)
    assert get_plan(clone, cache=cache, **base) is get_plan(PG, cache=cache, **base)

    # The device is the port's own key component: a card plan of the same
    # topology is another entry (the key is made without building).
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    on_card = plan_key_for(PG, **{**base, "device": "cuda"})
    assert on_card != plan_key_for(PG, **base)
    assert on_card.device == "cuda" and on_card not in cache


def test_cache_bypass_for_uncacheable_inputs():
    cache = PlanCache()
    a = get_plan(PG, exchange=SparseDeltaExchange(), cache=cache, **CPU)
    b = get_plan(PG, exchange=SparseDeltaExchange(), cache=cache, **CPU)
    assert a is not b                                 # instances bypass cache
    c = get_plan(PG, backend=CudaBackend(), cache=cache, **CPU)
    assert c is not get_plan(PG, backend=CudaBackend(), cache=cache, **CPU)
    assert len(cache) == 0
    d = get_plan(PG, cache=False, **CPU)              # explicit cold build
    assert d is not get_plan(PG, cache=False, **CPU)


def test_cache_false_is_fully_cold():
    """cache=False neither reads nor fills the shared host state cache."""
    plan_mod._STATE_CACHE.clear()
    color_distributed(PG, problem="d1", cache=False, **CPU)
    assert len(plan_mod._STATE_CACHE) == 0
    color_distributed(PG, problem="d1", cache=PlanCache(), **CPU)
    assert len(plan_mod._STATE_CACHE) == 1            # cached path populates


def test_cache_true_means_default_cache():
    a = get_plan(PG, cache=True, **CPU)
    b = get_plan(PG, cache=None, **CPU)
    assert a is b
    assert a.key in default_plan_cache()
    assert color_distributed(PG, **CPU).colors.tolist() == a.run().colors.tolist()


def test_cached_plan_stored_under_its_own_key():
    cache = PlanCache()
    plan = get_plan(PG, problem="d2", exchange="delta", cache=cache, **CPU)
    assert plan.key in cache
    assert cache.keys() == [plan.key]
    assert cache.plans() == [plan]


def test_cache_lru_eviction_order():
    cache = PlanCache(maxsize=2)
    ka = get_plan(PG, problem="d1", cache=cache, **CPU).key
    kb = get_plan(PG, problem="d2", cache=cache, **CPU).key
    get_plan(PG, problem="d1", cache=cache, **CPU)   # touch A
    kc = get_plan(PG, problem="d1_2gl", cache=cache, **CPU).key
    assert len(cache) == 2
    assert kb not in cache                            # LRU evicted
    assert ka in cache and kc in cache
    assert cache.keys() == [ka, kc]                   # LRU -> MRU order


def test_cache_byte_bounded_eviction():
    probe = build_plan(PG, **CPU)
    assert probe.nbytes > 0
    budget = int(probe.nbytes * 2.5)          # fits ~2 same-sized plans
    cache = PlanCache(maxsize=32, max_bytes=budget)
    topologies = [partition_graph(hex_mesh(6, 4, k), 3, strategy="block",
                                  second_layer=True) for k in (3, 4, 5, 6)]
    keys = [get_plan(t, cache=cache, **CPU).key for t in topologies]
    assert cache.misses == len(topologies)
    assert len(cache) < len(topologies)       # byte limit forced eviction
    assert cache.total_bytes <= budget
    assert keys[-1] in cache                  # most recent always survives
    assert keys[0] not in cache               # LRU evicted first
    # A single over-budget plan is kept: the cache never self-empties.
    tiny = PlanCache(maxsize=8, max_bytes=1)
    k = get_plan(PG, cache=tiny, **CPU).key
    assert len(tiny) == 1 and k in tiny


def test_evict_listeners_and_clear():
    cache = PlanCache(maxsize=1)
    seen = []

    def listener(key, plan):
        seen.append((key, plan))

    cache.add_evict_listener(listener)
    a = get_plan(PG, problem="d1", cache=cache, **CPU)
    b = get_plan(PG, problem="d2", cache=cache, **CPU)
    assert seen == [(a.key, a)]
    cache.clear()
    assert seen == [(a.key, a), (b.key, b)] and len(cache) == 0
    del listener                              # held weakly: unregistered
    get_plan(PG, problem="d1", cache=cache, **CPU)
    get_plan(PG, problem="d2", cache=cache, **CPU)
    assert len(seen) == 2 and cache._evict_listeners == []


def test_plan_nbytes_counts_tensors_and_host_tables():
    plan = build_plan(PG, problem="d2", exchange="sparse_delta", **CPU)
    tensors = sum(v.numel() * v.element_size() for v in plan._st.values())
    assert plan.nbytes > tensors > 0
    assert plan.nbytes - tensors == sum(a.nbytes for a in (
        plan._active0, plan._gids, plan._ghost_gids, plan._real,
        plan._ghost_real, plan._vertex_gid))


def test_plan_key_records_resolved_engine():
    plan = build_plan(PG, engine="auto", **CPU)
    want = _repro_plan().key
    assert plan.key == PlanKey(
        topology=PG.signature, problem="d1", recolor_degrees=True,
        backend="reference", exchange="all_gather", engine="simulate",
        max_rounds=64, device="cpu")
    assert PG.signature == J_PG.signature and want.engine == plan.key.engine
    with pytest.raises(ValueError, match="process group"):
        build_plan(PG, engine="shard_map", **CPU)


def test_default_engine_runs_on_a_multi_card_host(monkeypatch):
    """Eight cards for three parts, where ``repro``'s ``"auto"`` would pick
    ``shard_map``: without a process group the port's defaults color on
    ``simulate``, and an explicit ``"shard_map"`` asks for the group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    got = color_distributed(PG, **CPU)
    assert_same_result(got, j_dist.color_distributed(J_PG, engine="simulate",
                                                     cache=False))
    assert plan_key_for(PG, **CPU).engine == "simulate"
    assert get_plan(PG, **CPU).key.engine == "simulate"
    with pytest.raises(ValueError, match="process group"):
        get_plan(PG, engine="shard_map", cache=False, **CPU)


@pytest.mark.parametrize("make", [
    lambda pg: build_plan(pg, state_cache=False, **CPU),
    lambda pg: get_plan(pg, cache=False, **CPU),
    lambda pg: ColoringPlan(pg, **CPU),
], ids=["build_plan", "cache_false", "direct"])
def test_uncached_plan_hashes_its_topology_on_first_key_read(make):
    """A plan built outside both caches (plans and host state) leaves
    ``pg.signature`` unhashed until its key is read; the key is then the
    cache's key."""
    pg = partition_graph(GRAPH, 3, strategy="block", second_layer=True)
    plan = make(pg)
    plan.run()
    assert "_signature" not in vars(pg)
    assert plan.key == plan_key_for(pg, **CPU)
    assert "_signature" in vars(pg) and plan.key is plan.key


# ---------------------------------------------------------------------------
# plan.run() equal to repro's, all problems x backends x a few exchanges.
# ---------------------------------------------------------------------------

_CACHE = PlanCache(maxsize=64)


@pytest.mark.parametrize("problem", ["d1", "d1_2gl", "d2", "pd2"])
@pytest.mark.parametrize("exchange", ["all_gather", "delta", "sparse_delta"])
def test_plan_run_matches_repro(problem, exchange):
    want = _repro_plan(problem=problem, exchange=exchange).run()
    for backend in BACKENDS:
        plan = get_plan(PG, problem=problem, backend=backend, exchange=exchange,
                        cache=_CACHE, **CPU)
        assert plan.key.backend == backend
        warm = plan.run()
        assert_same_result(warm, want)
        assert_same_result(plan.run(), want)
        cold = color_distributed(PG, problem=problem, backend=backend,
                                 exchange=exchange, cache=False, **CPU)
        assert_same_result(cold, want)
        if problem != "pd2":
            assert VALIDATORS[problem](GRAPH, warm.colors)


# ---------------------------------------------------------------------------
# Warm-path contract: no host rebuild, no second loop build.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,exchange", [
    ("reference", "sparse_delta"),
    ("reference", "hier_delta"),
    ("cuda_fused", "all_gather"),
])
def test_warm_run_no_host_rebuild_no_retrace(monkeypatch, backend, exchange):
    plan = build_plan(PG, problem="d2", backend=backend, exchange=exchange, **CPU)
    assert plan.stats.traces == 1 and plan.stats.build_ms > 0
    first = plan.run()
    assert plan.stats.compiles == 1 and plan.stats.compile_ms > 0

    def _forbidden(*a, **kw):
        raise AssertionError("warm plan.run() rebuilt host state")

    monkeypatch.setattr(plan_mod, "build_device_state", _forbidden)
    monkeypatch.setattr(plan_mod, "cached_device_state", _forbidden)
    monkeypatch.setattr(plan._strategy, "prepare", _forbidden)
    mask = np.arange(GRAPH.n) % 3 != 0
    second = plan.run()
    masked = plan.run(color_mask=mask)                # dynamic input only
    seeded = plan.run(seed=7)
    assert plan.stats.traces == 1                     # the loop built once
    assert plan.stats.runs == 4 and plan.stats.compiles == 1
    assert plan.stats.last_run_ms > 0
    assert_same_result(second, first)
    assert_same_result(seeded, first)                 # deterministic runtime
    assert set(np.nonzero(masked.colors)[0]) <= set(np.nonzero(mask)[0])
    want = _repro_plan(problem="d2", exchange=exchange).run(color_mask=mask)
    assert_same_result(masked, want)


def test_color_mask_and_colors0_through_plan():
    mask = np.arange(GRAPH.n) < GRAPH.n // 2
    jplan = _repro_plan()
    for backend in BACKENDS:
        plan = get_plan(PG, backend=backend, cache=_CACHE, **CPU)
        via_plan = plan.run(color_mask=mask)
        assert_same_result(via_plan, jplan.run(color_mask=mask))
        direct = color_distributed(PG, backend=backend, color_mask=mask,
                                   cache=False, **CPU)
        assert_same_result(direct, via_plan)
        # colors0 seeds the frozen half; the active half colors properly.
        base = plan.run().colors
        warm_start = plan.run(color_mask=mask, colors0=base)
        assert (warm_start.colors[~mask] == base[~mask]).all()
        assert_same_result(warm_start, jplan.run(color_mask=mask, colors0=base))


# ---------------------------------------------------------------------------
# Host device-state cache (shared with baseline / Jones-Plassmann).
# ---------------------------------------------------------------------------

def test_cached_device_state_shared_and_unmutated():
    pg_a = partition_graph(GRAPH, 3, strategy="block", second_layer=True)
    pg_b = partition_graph(GRAPH, 3, strategy="block", second_layer=True)
    st_a = plan_mod.cached_device_state(pg_a, "d2")
    st_b = plan_mod.cached_device_state(pg_b, "d2")
    assert st_a is st_b                               # content-addressed
    assert plan_mod.cached_device_state(pg_a, "d1") is not st_a
    keys = set(st_a)
    snapshot = {k: v.copy() for k, v in st_a.items()}
    # Two plans of one topology: the second must still find active0, and
    # neither may pop from or merge into the shared dict.
    plans = [build_plan(pg, problem="d2", exchange="sparse_delta", **CPU)
             for pg in (pg_a, pg_b)]
    assert set(st_a) == keys and "active0" in st_a
    for k, v in snapshot.items():
        np.testing.assert_array_equal(st_a[k], v)
    assert_same_result(plans[1].run(), plans[0].run())
