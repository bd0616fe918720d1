"""The multi-GPU engine (``engine="shard_map"``) on gloo groups of CPU
processes, held against the ``simulate`` engine and against ``repro``.

One group of 4 spawned ranks runs the whole matrix on ``hex_mesh(24, 8,
8)`` with a second ghost layer (every problem × backend × exchange, the
sparse two in both transports, warm requests on d1), the pd2 case on an
edge-balanced ``rmat``, the slot surface and the service, and the error
paths of a group; one group of 8 runs ``hier_delta`` with nodes of 2 and
4 parts, two reduction passes and a frontend stream with a reduction
pass.  ``test_torch_shard_map_slots.py`` holds the service's own group.
Every rank must return the same result, equal in every field to the
port's ``simulate`` engine on the same partition; a few are also held
against ``repro``'s ``simulate`` engine (its ``shard_map`` engine fails
here, see ROADMAP.md).  The rank side lives in ``_shard_map_ranks.py``,
which imports no jax.
"""
from __future__ import annotations

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _shard_map_ranks as ranks
from repro.core import distributed as j_dist
from repro.graph import generators as j_gen
from repro.graph.partition import partition_graph as j_partition
from repro_torch.core.plan import PlanCache, build_plan, get_plan
from repro_torch.core.reduce import reduce_colors
from repro_torch.core.validate import is_proper_d1, is_proper_d2
from repro_torch.launch import color as t_cli
from repro_torch.serve.coloring import ColoringFrontend

MATRIX = list(ranks.matrix_cases())
HIER = list(ranks.hier_cases())


def assert_same_result(got, want):
    np.testing.assert_array_equal(got.colors, want.colors)
    for f in ("rounds", "converged", "total_conflicts", "n_colors",
              "comm_bytes_per_round", "comm_bytes_total", "problem", "n_parts",
              "backend", "exchange"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("comm_bytes_by_round", "comm_bytes_by_level"):
        a, b = getattr(got, f), getattr(want, f)
        if a is None or b is None:          # a reduced result keeps none
            assert a is b, f
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b)


def assert_ranks_agree(results):
    """Every rank returned the same result; rank 0's."""
    for r in results[1:]:
        assert_same_result(r, results[0])
    return results[0]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The parent's references on one thread, as each rank runs: at these
    sizes more threads only spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def matrix(tmp_path_factory):
    return ranks.run_group(tmp_path_factory.mktemp("shard_map4"), 4, "matrix")


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    return ranks.run_group(tmp_path_factory.mktemp("shard_map8"), 8, "eight")


@pytest.fixture(scope="module")
def pg4():
    return ranks.hex_pg(4)


@pytest.fixture(scope="module")
def pg8():
    return ranks.hex_pg(8)


@pytest.mark.parametrize("case", MATRIX, ids=[ranks.case_id(*c) for c in MATRIX])
def test_matrix_equals_simulate(matrix, pg4, case):
    """d1, d1_2gl, d2, pd2 × reference, cuda, cuda_fused × every exchange:
    the same result on every rank, equal in every field to ``simulate``."""
    problem, backend, name, kw = case
    got = assert_ranks_agree([out["cold"][ranks.case_id(*case)] for out in matrix])
    want = ranks.color(pg4, problem, backend, ranks.exchange(name, kw, backend),
                       "simulate")
    assert_same_result(got, want)


WARM = [c for c in MATRIX if c[0] == "d1" and c[1] == "cuda_fused"]


@pytest.mark.parametrize("case", WARM, ids=[ranks.case_id(*c) for c in WARM])
def test_warm_request_equals_simulate(matrix, pg4, case):
    """A warm 10% request through one plan, on every exchange."""
    _, backend, name, kw = case
    cid = ranks.case_id(*case)
    got = assert_ranks_agree([out["warm"][cid] for out in matrix])
    plan = build_plan(pg4, backend=backend, exchange=ranks.exchange(name, kw, backend),
                      engine="simulate", device="cpu")
    mask, c0 = ranks.warm_inputs(pg4, plan.run().colors)
    assert_same_result(got, plan.run(color_mask=mask, colors0=c0))
    assert got.n_colors > 0


def _repro(pg_args, problem, exchange):
    jpg = j_partition(*pg_args[0], **pg_args[1])
    return j_dist.color_distributed(jpg, problem=problem, exchange=exchange,
                                    backend="reference", engine="simulate", cache=False)


HEX = ((j_gen.hex_mesh(24, 8, 8), 4), {"second_layer": True})
RMAT = ((j_gen.rmat(6, 6, seed=5), 4), {"strategy": "edge_balanced", "second_layer": True})
AGAINST_REPRO = [("d1", name) for name in
                 ("all_gather", "halo", "delta", "sparse_delta", "hier_delta")]
AGAINST_REPRO.append(("d2", "sparse_delta"))


@pytest.mark.parametrize("problem, name", AGAINST_REPRO,
                         ids=[f"{p}/{n}" for p, n in AGAINST_REPRO])
def test_equals_repro(matrix, problem, name):
    """Against ``repro``'s ``simulate`` engine, each transport of the
    exchange (the bytes count the same pairs either way)."""
    want = _repro(HEX, problem, name)
    for (p, backend, n, kw) in MATRIX:
        if (p, backend, n) == (problem, "reference", name):
            got = matrix[0]["cold"][ranks.case_id(p, backend, n, kw)]
            assert_same_result(got, want)


def test_pd2_rmat_equals_repro(matrix):
    """pd2 on an edge-balanced ``rmat``, ``cuda_fused`` with ``sparse_delta``."""
    got = assert_ranks_agree([out["rmat_pd2"] for out in matrix])
    want = _repro(RMAT, "pd2", "sparse_delta")
    np.testing.assert_array_equal(got.colors, want.colors)
    for f in ("rounds", "converged", "total_conflicts", "n_colors"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.comm_bytes_by_level, want.comm_bytes_by_level)
    assert_same_result(got, ranks.color(ranks.rmat_pg(), "pd2", "cuda_fused",
                                        "sparse_delta", "simulate"))


def test_group_plans(matrix, pg4):
    """In a group of ``n_parts`` ranks ``"auto"`` resolves to ``shard_map``
    (and to ``simulate`` for another part count); every rank derives the
    simulate plan's route plans, and reports the global ``nbytes``."""
    keys = {out["key"] for out in matrix}
    assert len(keys) == 1
    key = keys.pop()
    assert key.engine == "shard_map" and key.device == "cpu"
    assert all(out["auto"] == ("shard_map", "simulate") for out in matrix)
    sparse = build_plan(pg4, exchange="sparse_delta", device="cpu", engine="simulate")
    hier = build_plan(pg4, exchange="hier_delta", device="cpu", engine="simulate")
    want = (sparse._strategy.route_phases(), hier._strategy.route_phases())
    assert want[0] and all(out["phases"] == want for out in matrix)
    assert all(out["nbytes"] == sparse.nbytes for out in matrix)


ERRORS = {
    "world": (ValueError, "4 ranks and the partition 3 parts"),
    "backend": (ValueError, "gloo process group cannot run a plan on cuda:0"),
    "service": (ValueError, "different refills"),
    "service_auto": (ValueError, "different refills"),
    "disagree": (ValueError, "different route plans"),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_group_error_paths(matrix, name):
    """A world size other than ``n_parts``, a backend that does not fit the
    device, services whose callers gave a request another priority on some
    ranks (``service``) or submitted in another order (``service_auto``)
    and ranks that derived different route plans all raise on every rank;
    nothing falls back."""
    _, match = ERRORS[name]
    for out in matrix:
        assert out["errors"][name] is not None and match in out["errors"][name], name


def test_slot_surface_raises_and_agreement_passes(matrix, pg4):
    """The slot surface by hand on the engine (three requests through two
    slots, one refill): each result equal on every rank to its solo
    ``plan.run`` there and to ``simulate``; ranks that agree pass."""
    plan = build_plan(pg4, exchange="sparse_delta", engine="simulate", device="cpu")
    for out in matrix:
        got, solo = out["slots"]
        assert len(got) == len(ranks.SLOT_MASKS)
        for g, s, k in zip(got, solo, ranks.SLOT_MASKS, strict=True):
            assert_same_result(g, s)
            assert_same_result(g, plan.run(color_mask=ranks.slot_mask(pg4, k)))
        assert out["errors"]["agree"] is None
    assert_same_result(ranks.run_slots(plan, ranks.SLOT_MASKS)[2], got[2])


def test_service_on_the_engine_equals_solo(matrix, pg4):
    """``ColoringService.run_batch`` on the engine (three warm requests,
    two slots): every rank's results equal its solo runs and ``simulate``."""
    plan = build_plan(pg4, backend="cuda_fused", engine="simulate", device="cpu")
    cold = plan.run()
    for out in matrix:
        got, solo, refills = out["service"]
        assert refills > 0
        for seed, (g, s) in enumerate(zip(got, solo, strict=True)):
            mask, c0 = ranks.warm_inputs(pg4, cold.colors, seed)
            assert_same_result(g, s)
            assert_same_result(g, plan.run(color_mask=mask, colors0=c0))


@pytest.mark.parametrize("case", HIER, ids=[f"node{n}/{p}/ragged={r}" for n, p, r in HIER])
def test_hier_delta_on_eight_ranks(eight, pg8, case):
    """``hier_delta`` with nodes of 2 and 4 parts, both transports of its
    intra stage, equal to ``simulate`` (bytes split by level included)."""
    node_size, problem, ragged = case
    from repro_torch.core.exchange import HierDeltaExchange

    got = assert_ranks_agree([out["hier"][case] for out in eight])
    want = ranks.color(pg8, problem, "cuda_fused",
                       HierDeltaExchange(scatter="cuda", node_size=node_size),
                       "simulate")
    assert_same_result(got, want)
    assert got.comm_bytes_intra > 0 and got.comm_bytes_inter > 0


@pytest.mark.parametrize("problem", ["d1", "d2"])
def test_reduce_colors_on_eight_ranks(eight, pg8, problem):
    """``repro``'s ``test_reduce_colors_shard_map`` contract: never more
    colors, proper, conflict-free supersteps, and the ``simulate`` engine's
    colors and ``colors_by_pass``."""
    res, red = eight[0]["reduce"][problem]
    for out in eight[1:]:
        r_res, r_red = out["reduce"][problem]
        assert_same_result(r_res, res)
        np.testing.assert_array_equal(r_red.colors, red.colors)
        assert r_red.colors_by_pass == red.colors_by_pass
    check = is_proper_d1 if problem == "d1" else is_proper_d2
    graph = j_gen.hex_mesh(24, 8, 8)
    assert red.n_colors <= res.n_colors and check(graph, red.colors)
    assert all(r == 0 for r in red.rounds_by_pass)
    cache = PlanCache()
    plan = get_plan(pg8, problem=problem, backend="cuda_fused", engine="simulate",
                    device="cpu", cache=cache)
    sim_res = plan.run()
    sim_red = reduce_colors(plan, sim_res, passes=2, cache=cache)
    assert_same_result(res, sim_res)
    np.testing.assert_array_equal(red.colors, sim_red.colors)
    assert red.colors_by_pass == sim_red.colors_by_pass
    assert red.comm_bytes_by_pass == sim_red.comm_bytes_by_pass


def test_frontend_stream_with_reduction_on_eight_ranks(eight, pg8):
    """``repro``'s ``test_frontend_stream_shard_map_with_reduction``: a
    frontend stream over two topologies with one reduction pass, its
    supersteps through the engine's slot steps; every rank's result equal
    to a solo ``simulate`` run and reduction."""
    pairs = ranks.reduce_pairs(pg8)
    results = [assert_ranks_agree([out["stream_reduce"][i] for out in eight])
               for i in range(len(pairs))]
    cache = PlanCache()
    for (pg, mask), got in zip(pairs, results, strict=True):
        plan = get_plan(pg, engine="simulate", device="cpu", cache=cache)
        base = plan.run(color_mask=mask)
        red = reduce_colors(plan, base, passes=1, cache=cache, color_mask=mask)
        assert_same_result(got, red.merged_result(base))
    assert is_proper_d1(j_gen.hex_mesh(24, 8, 8), results[0].colors)


def test_group_of_one_rank(tmp_path):
    """A group of one rank in this process, as on a one-card host: every
    exchange colors the one part as ``simulate`` does, and ``"auto"``
    keeps ``simulate`` for one part."""
    pg1 = ranks.partition_graph(ranks.hex_mesh(12, 6, 6), 1, second_layer=True)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=ranks.GROUP_TIMEOUT_S))
    try:
        for name, kw in ranks.TRANSPORTS:
            for problem in ("d1", "d2"):
                ex = ranks.exchange(name, kw, "cuda_fused")
                got = ranks.color(pg1, problem, "cuda_fused", ex, "shard_map")
                assert_same_result(got, ranks.color(pg1, problem, "cuda_fused", ex,
                                                    "simulate"))
        assert get_plan(pg1, device="cpu", cache=False).key.engine == "simulate"
    finally:
        dist.destroy_process_group()


def test_no_group_raises_and_cli_asks_for_torchrun(pg4, monkeypatch):
    """Without a process group ``shard_map`` raises naming torchrun (no
    fallback), at a plan's build and at a frontend's first submit, and the
    CLI asks for torchrun, in its service modes too."""
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="torchrun"):
        build_plan(pg4, engine="shard_map", device="cpu")
    fe = ColoringFrontend(engine="shard_map", device="cpu", cache=False)
    with pytest.raises(ValueError, match="torchrun"):
        fe.submit(pg4)
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    for mode in (["--graph", "hex:24,8,8"], ["--stream", "hex:6,4,4"],
                 ["--graph", "hex:24,8,8", "--repeat", "3"]):
        with pytest.raises(SystemExit, match="torchrun --nproc-per-node=4"):
            t_cli.main(mode + ["--parts", "4", "--engine", "shard_map", "--device", "cpu"])
