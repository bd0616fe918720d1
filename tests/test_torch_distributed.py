"""The port's distance-1 slice end to end against ``repro``'s simulate engine.

Both packages get the same graph and partition (byte-equal, see
``test_torch_graph.py``); ``repro`` runs ``color_distributed(problem="d1",
engine="simulate", exchange="all_gather", cache=False)`` with its
``reference`` backend (pinned bit-identical to ``pallas`` by
``tests/test_kernels.py``), and both of the port's backends run on the
CPU.  Every field is compared for equality.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as j_dist
from repro.core import exchange as j_exchange
from repro.core.plan import build_plan as j_build_plan
from repro.graph import generators as j_gen
from repro.graph.partition import partition_graph as j_partition
from repro_torch.core import distributed as t_dist
from repro_torch.core import exchange as t_exchange
from repro_torch.core.backend import get_backend
from repro_torch.core.plan import ColoringPlan
from repro_torch.core.validate import is_proper_d1
from repro_torch.graph import generators as t_gen
from repro_torch.graph.partition import partition_graph as t_partition
from repro_torch.launch import color as t_cli

GRAPHS = {
    "hex": ("hex_mesh", (8, 6, 6), {}),
    "grid": ("grid_2d", (20, 20), {}),
    "rmat": ("rmat", (8, 6), {"seed": 3}),
    "myc": ("mycielskian", (8,), {}),
}
FIELDS = ("rounds", "converged", "total_conflicts", "n_colors",
          "comm_bytes_per_round", "comm_bytes_total", "problem", "n_parts",
          "exchange")


def _pgs(gname, parts, strategy="edge_balanced"):
    fn, args, kw = GRAPHS[gname]
    jg, tg = getattr(j_gen, fn)(*args, **kw), getattr(t_gen, fn)(*args, **kw)
    return (jg, j_partition(jg, parts, strategy=strategy),
            tg, t_partition(tg, parts, strategy=strategy))


def assert_same_result(got, want):
    np.testing.assert_array_equal(got.colors, want.colors)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    for f in ("comm_bytes_by_round", "comm_bytes_by_level"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("gname", list(GRAPHS))
@pytest.mark.parametrize("parts", [1, 3, 8])
def test_color_distributed_matches_simulate(gname, parts):
    _, jpg, tg, tpg = _pgs(gname, parts)
    want = j_dist.color_distributed(jpg, problem="d1", engine="simulate",
                                    exchange="all_gather", cache=False)
    for backend in ("reference", "cuda"):
        got = t_dist.color_distributed(tpg, backend=backend, device="cpu")
        assert got.backend == backend
        assert_same_result(got, want)
        assert is_proper_d1(tg, got.colors)
    # repro's own PartitionedGraph, fed as it is to the port.
    assert_same_result(t_dist.color_distributed(jpg, backend="cuda", device="cpu"),
                       want)


@pytest.mark.parametrize("gname", list(GRAPHS))
def test_color_distributed_matches_without_recolor_degrees(gname):
    _, jpg, _, tpg = _pgs(gname, 3)
    want = j_dist.color_distributed(jpg, problem="d1", engine="simulate",
                                    recolor_degrees=False, cache=False)
    for backend in ("reference", "cuda"):
        got = t_dist.color_distributed(tpg, backend=backend, device="cpu",
                                       recolor_degrees=False)
        assert_same_result(got, want)


def test_round_cap_matches():
    """A run cut by max_rounds stops unconverged at the same point."""
    _, jpg, _, tpg = _pgs("rmat", 8)
    want = j_dist.color_distributed(jpg, problem="d1", engine="simulate",
                                    max_rounds=1, cache=False)
    assert not want.converged
    got = t_dist.color_distributed(tpg, backend="cuda", device="cpu", max_rounds=1)
    assert_same_result(got, want)


@pytest.mark.parametrize("gname", ["hex", "rmat"])
@pytest.mark.parametrize("clear_masked", [True, False])
def test_plan_warm_requests_match(gname, clear_masked):
    jg, jpg, _, tpg = _pgs(gname, 3)
    jplan = j_build_plan(jpg, problem="d1", engine="simulate", state_cache=False)
    tplans = [ColoringPlan(tpg, backend=b, device="cpu") for b in ("reference", "cuda")]
    prev = jplan.run()
    for tplan in tplans:
        assert_same_result(tplan.run(), prev)
    rng = np.random.default_rng(5)
    for step in range(3):
        mask = rng.random(jg.n) < 0.2
        colors0 = prev.colors.copy()
        if clear_masked:
            colors0[mask] = 0
        else:                   # masked vertices start from a clashing color
            colors0[mask] = 1
        want = jplan.run(color_mask=mask, colors0=colors0, seed=step)
        for tplan in tplans:
            for a, b in zip(tplan.request_inputs(mask, colors0, step),
                            jplan.request_inputs(mask, colors0, step)):
                np.testing.assert_array_equal(a, b)
            assert_same_result(tplan.run(color_mask=mask, colors0=colors0,
                                         seed=step), want)
        prev = want


def test_detect_part_matches_vmapped():
    """The ghost-lose scatter writes every duplicate index the same way."""
    _, jpg, _, tpg = _pgs("rmat", 3)
    st_np = j_dist.build_device_state(jpg, "d1")
    rng = np.random.default_rng(11)
    p, nl, g = jpg.n_parts, jpg.n_local, jpg.n_ghost
    colors = rng.integers(0, 3, (p, nl)).astype(np.int32)
    ghost = rng.integers(0, 3, (p, g)).astype(np.int32)
    for rd in (True, False):
        want = jax.vmap(lambda st, c, gh: j_dist._detect_part(
            st, c, gh, problem="d1", recolor_degrees=rd))(
            {k: jnp.asarray(v) for k, v in st_np.items()},
            jnp.asarray(colors), jnp.asarray(ghost))
        st = t_dist.state_to_torch(t_dist.build_device_state(tpg, "d1"), "cpu")
        for backend in ("reference", "cuda"):
            got = t_dist._detect_part(st, torch.from_numpy(colors),
                                      torch.from_numpy(ghost), problem="d1",
                                      recolor_degrees=rd,
                                      backend=get_backend(backend))
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert got[1].any()


def test_all_gather_exchange_matches():
    _, jpg, _, tpg = _pgs("grid", 8)
    st_np = j_dist.build_device_state(jpg, "d1")
    colors = np.random.default_rng(2).integers(
        0, 9, (jpg.n_parts, jpg.n_local)).astype(np.int32)
    jghost, jbytes, _ = j_exchange.AllGatherExchange().stacked(
        {k: jnp.asarray(v) for k, v in st_np.items()}, jnp.asarray(colors), ())
    ex = t_exchange.get_exchange("all_gather")
    st_t = t_dist.build_device_state(tpg, "d1")
    st = t_dist.state_to_torch({**st_t, **ex.prepare(tpg, st_t)}, "cpu")
    tghost, tbytes, _ = ex.stacked(st, torch.from_numpy(colors), ())
    np.testing.assert_array_equal(tghost.numpy(), np.asarray(jghost))
    np.testing.assert_array_equal(t_exchange.level_split(tbytes).numpy(),
                                  np.asarray(j_exchange.level_split(jbytes)))
    kw = dict(colors=7, masks=2, headers=3, pairs=5)
    assert (int(t_exchange.payload_bytes(st, **kw))
            == int(j_exchange.payload_bytes(st_np, **kw)))
    for bound in (0, 255, 256, 65535, 65536):
        assert (t_exchange.dtype_bytes(t_exchange.wire_dtype(bound))
                == j_exchange.dtype_bytes(j_exchange.wire_dtype(bound)))


def test_color_single_device_matches():
    fn, args, kw = GRAPHS["rmat"]
    want = j_dist.color_single_device(getattr(j_gen, fn)(*args, **kw))
    got = t_dist.color_single_device(getattr(t_gen, fn)(*args, **kw),
                                     backend="cuda", device="cpu")
    assert_same_result(got, want)


def test_unported_paths_raise():
    _, _, tg, tpg = _pgs("hex", 3)
    with pytest.raises(NotImplementedError, match="not ported"):
        t_dist.color_distributed(tpg, engine="shard_map", device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        ColoringPlan(t_partition(tg, 3, second_layer=True), problem="d2",
                     device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_backend("cuda").color_d2(*([None] * 7), partial_d2=False,
                                     recolor_degrees=True)
    with pytest.raises(ValueError, match="unknown backend"):
        get_backend("pallas")


def test_cli_colors_on_cpu(capsys):
    t_cli.main(["--graph", "hex:8,6,6", "--parts", "3", "--device", "cpu",
                "--backend", "cuda", "--repeat", "2"])
    out = capsys.readouterr().out
    assert "proper=True" in out and "repeat=2" in out
    assert "comm_bytes_by_round=[864, 864]" in out
