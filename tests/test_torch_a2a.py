"""The port's route plans and part factorization against ``repro``'s.

``schedule_a2a`` edge-colors a traffic graph by coloring its line graph
with the distance-1 algorithm, so the port's plans equal ``repro``'s only
if its coloring does: every phase, ``dst_of``/``src_of`` table and edge
set is compared for equality, on random traffic matrices made from numpy
seeds and on the traffic of the partitions the exchange tests use.  The
line graph is colored on the CPU (``device="cpu"``); without a device
argument it is colored on the card.
"""
import numpy as np
import pytest
import torch

from repro.core import a2a_schedule as j_a2a
from repro.graph import generators as j_gen
from repro.graph.partition import partition_graph as j_partition
from repro.graph.partition import two_level_partition as j_two_level
from repro.launch.mesh import factor_parts as j_factor
from repro_torch.core import a2a_schedule as t_a2a
from repro_torch.core.exchange import _peer_need
from repro_torch.launch.mesh import factor_parts as t_factor

CPU = {"device": "cpu"}


def _random_traffic(p, density, seed):
    rng = np.random.default_rng(seed)
    t = (rng.random((p, p)) < density).astype(np.int64)
    np.fill_diagonal(t, 0)
    return t


def _partition_traffic(kind):
    g = j_gen.hex_mesh(12, 8, 8) if kind == "flat" else j_gen.hex_mesh(12, 6, 6)
    pg = (j_partition(g, 4, second_layer=True) if kind == "flat"
          else j_two_level(g, 2, 2, second_layer=True))
    return _peer_need(pg).any(axis=2).astype(np.int64)


TRAFFIC = {
    **{f"random-p{p}-d{d}-s{s}": (p, d, s)
       for p, d, s in [(1, 0.5, 0), (2, 1.0, 1), (4, 0.6, 2), (8, 1.0, 3),
                       (8, 0.3, 4), (12, 0.5, 5), (12, 0.15, 6), (6, 0.9, 7)]},
    "flat-hex": "flat",
    "two-level-hex": "two_level",
}


def _traffic(name):
    spec = TRAFFIC[name]
    return _partition_traffic(spec) if isinstance(spec, str) else _random_traffic(*spec)


def assert_same_route_plan(got, want):
    assert got.n_parts == want.n_parts
    assert got.phases == want.phases
    assert got.edges == want.edges
    assert got.n_phases == want.n_phases
    for f in ("dst_of", "src_of"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(TRAFFIC))
@pytest.mark.parametrize("rd", [True, False])
def test_route_plans_match(name, rd):
    t = _traffic(name)
    assert t_a2a.phase_lower_bound(t) == j_a2a.phase_lower_bound(t)
    assert (t_a2a.schedule_a2a(t, recolor_degrees=rd, **CPU)
            == j_a2a.schedule_a2a(t, recolor_degrees=rd))
    assert_same_route_plan(t_a2a.exchange_route_plan(t, recolor_degrees=rd, **CPU),
                           j_a2a.exchange_route_plan(t, recolor_degrees=rd))


@pytest.mark.parametrize("name", list(TRAFFIC))
def test_hierarchical_route_plans_match(name):
    t = _traffic(name)
    p = t.shape[0]
    for node_size in [d for d in range(1, p + 1) if p % d == 0]:
        got = t_a2a.hierarchical_route_plan(t, node_size, **CPU)
        want = j_a2a.hierarchical_route_plan(t, node_size)
        for f in ("n_parts", "node_size", "n_nodes", "up", "down", "n_phases"):
            assert getattr(got, f) == getattr(want, f), f
        assert_same_route_plan(got.intra, want.intra)
        assert_same_route_plan(got.node, want.node)
        assert [got.node_of(q) for q in range(p)] == [want.node_of(q) for q in range(p)]
        assert got.leader_of(1) == want.leader_of(1)


def test_hierarchical_route_plan_rejects_bad_node_size():
    t = _random_traffic(6, 0.5, 0)
    for mod, kw in ((t_a2a, CPU), (j_a2a, {})):
        with pytest.raises(ValueError, match="divide"):
            mod.hierarchical_route_plan(t, 4, **kw)


def test_route_plan_colors_on_the_named_device():
    """``device=None`` colors on the card: without one it raises rather
    than fall back to the CPU; with one it gives the CPU's plan."""
    t = _random_traffic(4, 1.0, 1)
    if torch.cuda.is_available():
        assert_same_route_plan(t_a2a.exchange_route_plan(t),
                               t_a2a.exchange_route_plan(t, **CPU))
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_a2a.exchange_route_plan(t)
    # No edge, nothing to color: no device is touched.
    assert t_a2a.exchange_route_plan(np.zeros((3, 3), np.int64)).n_phases == 0


@pytest.mark.parametrize("n_parts", [1, 2, 4, 7, 8, 12, 16, 36])
def test_factor_parts_auto_matches(n_parts, monkeypatch):
    monkeypatch.delenv("REPRO_NODE_SIZE", raising=False)
    assert t_factor(n_parts) == j_factor(n_parts)
    for node_size in [d for d in range(1, n_parts + 1) if n_parts % d == 0]:
        assert t_factor(n_parts, node_size) == j_factor(n_parts, node_size)


def test_factor_parts_env_and_errors(monkeypatch):
    for env, want in (("4", (2, 4)), ("0", (4, 2)), ("8", (1, 8))):
        monkeypatch.setenv("REPRO_NODE_SIZE", env)
        assert t_factor(8) == j_factor(8) == want
    monkeypatch.setenv("REPRO_NODE_SIZE", "3")
    for fn in (t_factor, j_factor):
        with pytest.raises(ValueError, match="divide"):
            fn(8)
    monkeypatch.delenv("REPRO_NODE_SIZE")
    for fn, args in ((t_factor, (8, 3)), (t_factor, (0,)), (t_factor, (8, 0)),
                     (j_factor, (8, 3)), (j_factor, (0,)), (j_factor, (8, 0))):
        with pytest.raises(ValueError):
            fn(*args)
