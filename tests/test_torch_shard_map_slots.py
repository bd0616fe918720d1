"""The coloring service on the multi-GPU engine (``engine="shard_map"``):
``ColoringFrontend`` / ``ColoringService`` and the CLI's service modes on a
gloo group of 4 CPU processes, held against the solo runs on the engine,
the port's ``simulate`` engine and ``repro``'s.

One group runs ``_shard_map_ranks.job_slots``: ``repro``'s frontend stream
scenario through two slots (refills mid-wave), a stream with deadlines
whose ranks admit at skewed times, once with rank 0's admission clock and
once with each rank's own (which must raise), the service under
``engine="auto"`` and the CLI's ``--repeat``, ``--stream`` and
``--baseline``.  Every rank must return the same results.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _shard_map_ranks as ranks
from repro.core.plan import PlanCache as JPlanCache, get_plan as j_get_plan
from repro.graph import generators as j_gen
from repro.graph.partition import partition_graph as j_partition
from repro_torch.core.plan import PlanCache, get_plan
from repro_torch.core.validate import is_proper_d1
from test_torch_shard_map import assert_ranks_agree, assert_same_result


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def slots(tmp_path_factory):
    return ranks.run_group(tmp_path_factory.mktemp("shard_map_slots"), 4, "slots")


def agreed(outs, key):
    """Every rank's list under ``key`` is the same; rank 0's."""
    return [assert_ranks_agree([out[key][i] for out in outs])
            for i in range(len(outs[0][key]))]


def simulate(pg, mask, **kw):
    return get_plan(pg, engine="simulate", device="cpu", cache=SIM, **kw).run(
        color_mask=mask)


SIM = PlanCache()


def test_frontend_stream_equals_solo_and_simulate(slots):
    """``repro``'s ``test_frontend_stream_shard_map_slot_engine``: 12
    requests over two topologies through two slots refill mid-wave, and
    each equals its solo ``plan.run`` on the engine and ``simulate``."""
    refills, batches, requests, warm, engines = slots[0]["stream_stats"]
    assert refills > 0 and batches >= 2
    assert requests == warm == 12 and engines == ["shard_map"]
    got = agreed(slots, "stream")
    pairs = ranks.stream_pairs()
    for out in slots:
        for g, s in zip(got, out["stream_solo"], strict=True):
            assert_same_result(g, s)
    for (pg, mask), g in zip(pairs, got, strict=True):
        assert_same_result(g, simulate(pg, mask))
    assert is_proper_d1(j_gen.hex_mesh(12, 6, 6), got[0].colors)


def test_frontend_stream_equals_repro(slots):
    """The same stream against ``repro``'s ``simulate`` engine."""
    got = slots[0]["stream"]
    jpgs = (j_partition(j_gen.hex_mesh(12, 6, 6), 4, second_layer=True),
            j_partition(j_gen.rmat(8, 6, seed=5), 4, strategy="edge_balanced",
                        second_layer=True))
    cache = JPlanCache()
    for i, ((_, mask), g) in enumerate(zip(ranks.stream_pairs(), got, strict=True)):
        want = j_get_plan(jpgs[i % 2], engine="simulate", cache=cache).run(
            color_mask=mask)
        np.testing.assert_array_equal(g.colors, np.asarray(want.colors))
        for f in ("rounds", "converged", "total_conflicts", "n_colors"):
            assert getattr(g, f) == getattr(want, f), f
        for f in ("comm_bytes_by_round", "comm_bytes_by_level"):
            np.testing.assert_array_equal(getattr(g, f), np.asarray(getattr(want, f)))


def test_deadlines_under_skewed_admission(slots):
    """Ranks that admit requests with deadlines at skewed times (rank r
    sleeps r * 30 ms before every other submit) take rank 0's clock: the
    same order on every rank, and every result equal to its solo run."""
    got = agreed(slots, "skew")
    pg = ranks.stream_pairs()[0][0]
    for out in slots:
        for g, s in zip(got, out["skew_solo"], strict=True):
            assert_same_result(g, s)
    for i, g in enumerate(got):
        assert_same_result(g, simulate(pg, ranks.slot_mask(pg, i + 2),
                                       backend="cuda_fused", exchange="delta"))


def test_own_admission_clocks_raise(slots):
    """With each rank's own clock, the deadlines give keys that differ
    across ranks: the first refill raises on every rank instead of mixing
    two requests' rows."""
    for out in slots:
        assert out["own_clocks"] is not None and "different refills" in out["own_clocks"]


def test_service_auto_on_a_group(slots):
    """``ColoringService(pg)`` in a group of ``n_parts`` ranks resolves
    ``"auto"`` to ``shard_map``; its ``run_batch`` (five requests, four
    slots, ``sparse_delta``) equals the solo runs and ``simulate``."""
    pg = ranks.stream_pairs()[0][0]
    for out in slots:
        engine, got, solo, refills = out["auto"]
        assert engine == "shard_map" and refills > 0
        for g, s in zip(got, solo, strict=True):
            assert_same_result(g, s)
    for k, g in zip(range(2, 7), slots[0]["auto"][1], strict=True):
        assert_same_result(g, simulate(pg, ranks.slot_mask(pg, k), backend="cuda_fused",
                                       exchange="sparse_delta"))


def _steady(lines):
    """The printed lines less their timings."""
    out = []
    for line in lines:
        for timed in (" time=", " engine=", " req/s "):
            line = line.split(timed)[0]
        out.append(line)
    return out


@pytest.mark.parametrize("name", sorted(ranks.CLI_RUNS))
def test_cli_service_modes_on_a_group(slots, name):
    """The CLI's ``--repeat``, ``--stream`` and ``--baseline`` (with a
    reduction pass) through ``run_one`` on the group: proper, the same
    lines on every rank, and those of the ``simulate`` engine."""
    lines = [_steady(out["cli"][name]) for out in slots]
    assert all(x == lines[0] for x in lines[1:])
    assert lines[0] == _steady(ranks.cli_lines(name, "simulate"))
    text = "\n".join(slots[0]["cli"][name])
    assert "refills=" in text if name == "stream" else "proper=True" in text
    if name == "repeat":
        assert "repeat=3 engine=shard_map" in text
