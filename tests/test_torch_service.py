"""The port's ``ColoringService`` against ``repro``'s: every batch result
equal in every field, the service's counters, buckets and programs equal,
and every result equal to the port's own solo ``plan.run``.

The counterparts of the service tests of ``tests/test_plan.py`` and the
batch matrix of the continuous-batching service: backends ``reference``
and ``cuda_fused`` (the kernel wrappers take their plain versions on the
CPU), exchanges ``all_gather`` and ``sparse_delta``, problems d1 and d2,
batches of 1, 3, 5 and more than ``max_batch``, ``reduce_passes`` 0 and 1.
Both packages get the same ``PartitionedGraph`` and the same requests;
``repro`` runs its ``reference`` backend (pinned bit-identical to
``pallas`` by its own tests) on ``simulate``.
"""
import copy
import functools

import numpy as np
import pytest
import torch

from repro.core.plan import PlanCache as JPlanCache
from repro.graph import generators as j_gen
from repro.graph.partition import partition_graph as j_partition
from repro.serve import ColoringService as JColoringService
from repro_torch.core.plan import PlanCache
from repro_torch.core.validate import is_proper_d1
from repro_torch.graph import generators as t_gen
from repro_torch.graph.partition import partition_graph
from repro_torch.serve import ColoringRequest, ColoringService

CPU = dict(device="cpu")
GRAPH = t_gen.hex_mesh(6, 4, 4)
PG = partition_graph(GRAPH, 3, strategy="block", second_layer=True)
J_PG = j_partition(j_gen.hex_mesh(6, 4, 4), 3, strategy="block", second_layer=True)
MAX_BATCH = 4
SIZES = (1, 3, 5, 6)            # solo, one wave, a wave and refills
STAT_FIELDS = ("requests", "batches", "refills", "warm_requests", "rejected",
               "shed", "by_tenant", "cold_runs")
RESULT_FIELDS = ("rounds", "converged", "total_conflicts", "n_colors",
                 "comm_bytes_total", "comm_bytes_per_round", "problem", "n_parts",
                 "exchange")


def assert_same_result(got, want):
    np.testing.assert_array_equal(got.colors, want.colors)
    for f in RESULT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    for f in ("comm_bytes_by_round", "comm_bytes_by_level"):
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b)


def stats_of(svc) -> dict:
    return copy.deepcopy({f: getattr(svc.stats, f) for f in STAT_FIELDS})


def _requests(problem: str, n: int) -> list[dict]:
    """``n`` plan inputs: full recolorings and warm 30% recolorings of a
    proper coloring (numpy, the same for both packages)."""
    rng = np.random.default_rng({"d1": 1, "d2": 2}[problem])
    base = ColoringService(PG, problem=problem, cache=PlanCache(), **CPU).submit().colors
    reqs = []
    for i in range(n):
        if i % 3 == 0:
            reqs.append({})
        else:
            m = rng.random(PG.n_global) < 0.3
            reqs.append({"color_mask": m, "colors0": np.where(m, 0, base)})
    return reqs


@functools.lru_cache(maxsize=None)
def _batches(problem: str) -> tuple:
    """The request batches of :data:`SIZES`, cut from one list."""
    reqs = _requests(problem, sum(SIZES))
    cuts = np.cumsum((0,) + SIZES)
    return tuple(reqs[a:b] for a, b in zip(cuts[:-1], cuts[1:]))


@functools.lru_cache(maxsize=None)
def _repro_outcome(problem: str, exchange: str, reduce_passes: int):
    """``repro``'s results and service state after each batch (run once
    per configuration and shared by the port's backends)."""
    svc = JColoringService(J_PG, problem=problem, exchange=exchange,
                           engine="simulate", cache=JPlanCache(),
                           max_batch=MAX_BATCH, reduce_passes=reduce_passes)
    out = []
    for batch in _batches(problem):
        res = svc.run_batch([dict(r) for r in batch])
        out.append((res, stats_of(svc), svc.buckets,
                    svc._frontend.n_programs))
    return out


# (problem, exchange, reduce_passes): each problem with both exchanges,
# reduction on d1 (its supersteps build buckets of 1, 2 and 4 as well).
CONFIGS = (("d1", "all_gather", 0), ("d1", "sparse_delta", 1),
           ("d2", "all_gather", 0), ("d2", "sparse_delta", 0))
CASES = [(p, x, b, r) for p, x, r in CONFIGS for b in ("reference", "cuda_fused")]


@pytest.mark.parametrize("problem,exchange,backend,reduce_passes", CASES)
def test_service_batches_match_repro(problem, exchange, backend, reduce_passes):
    svc = ColoringService(PG, problem=problem, exchange=exchange, backend=backend,
                          cache=PlanCache(), max_batch=MAX_BATCH,
                          reduce_passes=reduce_passes, **CPU)
    want = _repro_outcome(problem, exchange, reduce_passes)
    solo = ColoringService(PG, problem=problem, exchange=exchange, backend=backend,
                           cache=PlanCache(), reduce_passes=reduce_passes, **CPU)
    for batch, (j_res, j_stats, j_buckets, j_programs) in zip(_batches(problem), want):
        got = svc.run_batch([ColoringRequest(**r) for r in batch])
        assert len(got) == len(batch)
        for r, g, j in zip(batch, got, j_res):
            assert_same_result(g, j)
            assert_same_result(g, solo.submit(**r))
        assert stats_of(svc) == j_stats
        assert svc.buckets == j_buckets
        assert svc._frontend.n_programs == j_programs
    # Batches larger than max_batch streamed through refills.
    assert max(svc.buckets) == MAX_BATCH and svc.stats.refills > 0


def test_service_batch_bit_identical_to_solo():
    """Batch sizes 3 and 5 take power-of-two buckets (4, 8); every element
    equals its solo run and ``repro``'s result."""
    n = GRAPH.n
    masks = [None, np.arange(n) < n // 2, np.arange(n) % 2 == 0,
             np.arange(n) % 3 != 0, np.arange(n) >= n // 3]
    svc = ColoringService(PG, exchange="delta", backend="cuda_fused",
                          cache=PlanCache(), **CPU)
    jsvc = JColoringService(J_PG, exchange="delta", engine="simulate",
                            cache=JPlanCache())
    for size in (3, 5):
        reqs = [{"color_mask": m} for m in masks[:size]]
        batch = svc.run_batch(reqs)
        assert len(batch) == size
        for req, b, j in zip(reqs, batch, jsvc.run_batch(reqs)):
            assert_same_result(b, j)
            assert_same_result(b, svc.plan.run(**req))
    assert svc.buckets == jsvc.buckets == [4, 8]


def test_service_stats_cold_vs_warm():
    """Program builds are cold events, every request's execution is warm,
    and the counters move as ``repro``'s do.  ``repro``'s
    ``warm_ms_mean < cold_ms`` rests on XLA compile time and is not
    ported."""
    svc = ColoringService(PG, cache=PlanCache(), **CPU)
    jsvc = JColoringService(J_PG, engine="simulate", cache=JPlanCache())

    def both(fn):
        fn(svc), fn(jsvc)
        assert stats_of(svc) == stats_of(jsvc)

    both(lambda s: s.submit())
    assert svc.stats.cold_runs == 1                   # the plan's first run
    assert svc.stats.cold_ms > 0 and svc.stats.warm_requests == 1
    for _ in range(3):
        both(lambda s: s.submit())
    assert svc.stats.requests == 4 and svc.stats.cold_runs == 1
    assert svc.stats.warm_ms_mean > 0
    cold_ms = svc.stats.cold_ms
    both(lambda s: s.run_batch([{}, {}]))
    assert svc.stats.cold_runs == 3                   # step + refill
    assert svc.stats.cold_ms > cold_ms
    cold = (svc.stats.cold_runs, svc.stats.cold_ms)
    both(lambda s: s.run_batch([{}, {}]))
    assert (svc.stats.cold_runs, svc.stats.cold_ms) == cold   # bucket reused
    assert svc.stats.warm_requests == 8


def test_service_empty_and_single_batches():
    svc = ColoringService(PG, cache=PlanCache(), **CPU)
    assert svc.run_batch([]) == []
    [res] = svc.run_batch([{}])
    assert is_proper_d1(GRAPH, res.colors)
    assert svc.buckets == []                          # one request: solo path


@pytest.mark.parametrize("batch", [
    [{"mask": None}, {}],                             # typo for color_mask
    [{"color_mask": None, "seeds": 1}],
])
def test_service_rejects_unknown_request_keys(batch):
    svc = ColoringService(PG, cache=PlanCache(), **CPU)
    jsvc = JColoringService(J_PG, engine="simulate", cache=JPlanCache())
    with pytest.raises(TypeError, match="unknown request keys") as got:
        svc.run_batch(batch)
    with pytest.raises(TypeError) as want:
        jsvc.run_batch(batch)
    assert str(got.value) == str(want.value)


def test_service_slot_carry_layout():
    """The carry is ``repro``'s with the request axis leading; a refill
    resets every leaf of its row and the step leaves idle slots alone."""
    svc = ColoringService(PG, exchange="sparse_delta", cache=PlanCache(), **CPU)
    plan = svc.plan
    ex = plan.slot_ex_init()
    carry = plan.slot_carry(4, ex)
    p, n, g = PG.n_parts, PG.n_local, PG.n_ghost
    assert carry["colors"].shape == (4, p, n) and carry["colors"].dtype == torch.int32
    assert carry["ghost"].shape == (4, p, g) and carry["lose_g"].dtype == torch.bool
    assert carry["ex_state"]["ghost_tab"].shape == (4,) + tuple(ex["ghost_tab"].shape)
    assert carry["bytes"].shape == (4, plan.max_rounds + 1, 2)
    assert list(carry["rounds"]) == [plan.max_rounds] * 4 and not carry["live"].any()
    carry["ex_state"]["ghost_tab"].fill_(7)           # stale state of a finished slot
    c0, g0, a0, _ = plan.request_inputs()
    carry = plan.slot_refill(ex)(carry, np.int32(2), *plan.slot_args(c0, g0, a0))
    assert not carry["ex_state"]["ghost_tab"][2].any()
    assert (carry["ex_state"]["ghost_tab"][[0, 1, 3]] == 7).all()
    assert int(carry["conf"][2]) == 1 and carry["rounds"][2] == -1
    traces = plan.stats.traces
    step = plan.slot_step()
    assert plan.stats.traces == traces + 1            # a step build is counted
    while not (done := step(carry)[1])[2]:
        pass
    assert done.all() and (carry["ex_state"]["ghost_tab"][[0, 1, 3]] == 7).all()
    assert_same_result(plan._result(carry["colors"][2], int(carry["rounds"][2]),
                                    carry["conf"][2], carry["total"][2],
                                    carry["bytes"][2]), plan.run())


def test_service_raises_without_a_card(monkeypatch):
    from repro_torch.serve import ColoringFrontend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ColoringService(PG, cache=PlanCache())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ColoringFrontend(cache=PlanCache())
