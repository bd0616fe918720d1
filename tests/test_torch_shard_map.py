"""The multi-GPU engine (``engine="shard_map"``) on gloo groups of CPU
processes, held against the ``simulate`` engine and against ``repro``.

One group of 4 spawned ranks runs the whole matrix on ``hex_mesh(24, 8,
8)`` with a second ghost layer (every problem × backend × exchange, the
sparse two in both transports, warm requests on d1), the pd2 case on an
edge-balanced ``rmat`` and the error paths of a group; one group of 8
runs ``hier_delta`` with nodes of 2 and 4 parts and two reduction passes.
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
    "service": (NotImplementedError, "shard_map"),
    "service_auto": (NotImplementedError, "shard_map"),
    "disagree": (ValueError, "different route plans"),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_group_error_paths(matrix, name):
    """A world size other than ``n_parts``, a backend that does not fit the
    device, the service on the engine and ranks that derived different
    route plans all raise on every rank; nothing falls back."""
    _, match = ERRORS[name]
    for out in matrix:
        assert out["errors"][name] is not None and match in out["errors"][name], name


def test_slot_surface_raises_and_agreement_passes(matrix):
    for out in matrix:
        assert len(out["errors"]["slots"]) == 5
        assert all(m is not None and "ROADMAP" in m for m in out["errors"]["slots"])
        assert out["errors"]["agree"] is None


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
    """Without a process group ``shard_map`` raises naming the group (no
    fallback), the frontend refuses the engine, and the CLI asks for
    torchrun."""
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="torchrun"):
        build_plan(pg4, engine="shard_map", device="cpu")
    with pytest.raises(NotImplementedError, match="shard_map"):
        ColoringFrontend(engine="shard_map", device="cpu")
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node=4"):
        t_cli.main(["--graph", "hex:24,8,8", "--parts", "4", "--engine", "shard_map",
                    "--device", "cpu"])
