"""The port's ghost exchanges against ``repro``'s simulate engine.

Both packages get the same graph and partition; ``repro`` runs
``color_distributed(engine="simulate", exchange=..., cache=False)`` with
its ``reference`` backend and ``reference`` pair scatter (pinned
bit-identical to ``pallas`` by its own tests), and the port runs the same
exchange on its three backends on the CPU, where the kernel wrappers
(``pair_scatter`` among them) take their plain versions.  Every field is
compared for equality, ``comm_bytes_by_round`` and ``comm_bytes_by_level``
included.  The graphs are ``repro``'s own: ``hex_mesh(12, 8, 8)`` over 4
block slabs (every exchange, every problem ``repro``'s tests run it on)
and ``two_level_partition(hex_mesh(12, 6, 6), 2, 2)``.  The port's
``scatter="cuda"`` is held against ``repro``'s ``scatter="pallas"``
(interpret mode) once.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as j_dist
from repro.core import exchange as j_ex
from repro.core.plan import build_plan as j_build_plan
from repro.graph import generators as j_gen
from repro.graph.csr import build_graph as j_build_graph
from repro.graph.partition import partition_graph as j_partition
from repro.graph.partition import two_level_partition as j_two_level
from repro_torch.core import distributed as t_dist
from repro_torch.core import exchange as t_ex
from repro_torch.core.plan import ColoringPlan
from repro_torch.core.validate import is_proper_d1, is_proper_d2
from repro_torch.graph import generators as t_gen
from repro_torch.graph.csr import build_graph as t_build_graph
from repro_torch.graph.partition import partition_graph as t_partition
from repro_torch.graph.partition import two_level_partition as t_two_level
from repro_torch.kernels.scatter import pair_scatter
from repro_torch.launch import color as t_cli
from test_torch_distributed import BACKENDS, assert_same_result

EXCHANGES = ("halo", "delta", "sparse_delta", "hier_delta")
PROBLEMS = ("d1", "d1_2gl", "d2", "pd2")


@functools.cache
def _flat(problem):
    """hex_mesh(12, 8, 8) over 4 block slabs, in both packages."""
    l2 = problem != "d1"
    return (j_partition(j_gen.hex_mesh(12, 8, 8), 4, second_layer=l2),
            t_partition(t_gen.hex_mesh(12, 8, 8), 4, second_layer=l2))


@functools.cache
def _two_level():
    return (j_two_level(j_gen.hex_mesh(12, 6, 6), 2, 2, second_layer=True),
            t_two_level(t_gen.hex_mesh(12, 6, 6), 2, 2, second_layer=True))


_WANT: dict = {}


def _want(jpg, problem, exchange, **kw):
    """``repro``'s simulate result, computed once for each named exchange
    on one partition (the entry keeps ``jpg`` alive, so its id stays its
    own); an exchange instance runs every time."""
    def run():
        return j_dist.color_distributed(jpg, problem=problem, engine="simulate",
                                        exchange=exchange, cache=False, **kw)
    if not isinstance(exchange, str):
        return run()
    key = (id(jpg), problem, exchange, tuple(sorted(kw.items())))
    if key not in _WANT:
        _WANT[key] = (jpg, run())
    return _WANT[key][1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One thread, as the suite's workers share the cores: at these sizes
    more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _check_all_backends(tpg, want, problem, exchange, **kw):
    """Every backend of the port equals ``want``; returns the last result."""
    for backend in BACKENDS:
        got = t_dist.color_distributed(tpg, problem=problem, backend=backend,
                                       exchange=exchange, device="cpu", **kw)
        assert got.backend == backend and got.exchange == want.exchange
        assert_same_result(got, want)
    return got


@pytest.mark.parametrize("problem", PROBLEMS)
@pytest.mark.parametrize("exchange", EXCHANGES)
def test_exchange_matches_simulate(exchange, problem):
    jpg, tpg = _flat(problem)
    assert tpg.halo_neighbors_ok()
    want = _want(jpg, problem, exchange)
    got = _check_all_backends(tpg, want, problem, exchange)
    assert got.converged and got.comm_bytes_by_level.shape == (got.rounds + 1, 2)
    # The exchange is a pure transport: all_gather's coloring, its own bytes.
    ag = _want(jpg, problem, "all_gather") if problem == "d1" else None
    if ag is not None:
        assert (got.colors == ag.colors).all() and got.rounds == ag.rounds
        assert got.comm_bytes_total < ag.comm_bytes_total


@pytest.mark.parametrize("problem", PROBLEMS)
@pytest.mark.parametrize("exchange", ["sparse_delta", "hier_delta"])
def test_two_level_partition_matches_simulate(exchange, problem):
    jpg, tpg = _two_level()
    got = _check_all_backends(tpg, _want(jpg, problem, exchange), problem, exchange)
    if exchange == "hier_delta":
        assert got.comm_bytes_intra > 0 and got.comm_bytes_inter > 0
        if problem in ("d1", "d2"):
            proper = is_proper_d2 if problem == "d2" else is_proper_d1
            assert proper(t_gen.hex_mesh(12, 6, 6), got.colors)
    else:
        assert got.comm_bytes_intra == 0


def test_comm_ordering_hier_sparse_all_gather():
    """repro's ordering on the two-level partition holds for the port."""
    _, tpg = _two_level()
    res = {ex: t_dist.color_distributed(tpg, exchange=ex, device="cpu")
           for ex in ("all_gather", "sparse_delta", "hier_delta")}
    ag, sd, hd = res["all_gather"], res["sparse_delta"], res["hier_delta"]
    assert (sd.colors == ag.colors).all() and (hd.colors == ag.colors).all()
    assert hd.comm_bytes_total < sd.comm_bytes_total < ag.comm_bytes_total


@pytest.mark.parametrize("case", ["node2", "node1", "rmat", "dense", "wide-slots"])
def test_hier_delta_wire_widths_and_node_sizes(case):
    """repro's hier_delta cases: explicit node sizes on a flat partition,
    palettes crossing 255 (rmat: uint8 for d1, uint16 for d2) and 65535
    (dense: uint16 for d1, int32 for d2), send widths over 255.  The
    colorings run d1 (the d2 runs on rmat cost half a minute each); the
    d2 widths are compared from prepare()."""
    spec, strategy, parts, node_size = {
        "node2": (("rmat", (8, 6), {"seed": 5}), "edge_balanced", 4, 2),
        "node1": (("rmat", (8, 6), {"seed": 5}), "edge_balanced", 4, 1),
        "rmat": (("rmat", (8, 6), {"seed": 5}), "edge_balanced", 4, None),
        "dense": (("erdos_renyi", (600, 400), {}), "edge_balanced", 4, None),
        "wide-slots": (("hex_mesh", (12, 8, 8), {}), "random", 2, None),
    }[case]
    fn, args, kw = spec
    jg, tg = getattr(j_gen, fn)(*args, **kw), getattr(t_gen, fn)(*args, **kw)
    jpg = j_partition(jg, parts, strategy=strategy, second_layer=True)
    tpg = t_partition(tg, parts, strategy=strategy, second_layer=True)
    jex = j_ex.HierDeltaExchange(node_size=node_size)
    want = _want(jpg, "d1", jex)
    for backend in ("reference", "cuda_fused"):
        got = t_dist.color_distributed(
            tpg, backend=backend, exchange=t_ex.HierDeltaExchange(node_size=node_size),
            device="cpu")
        assert_same_result(got, want)
    # The packed widths a plan chooses are repro's.
    for problem in ("d1", "d2"):
        tex = t_ex.HierDeltaExchange(node_size=node_size)
        jex.prepare(jpg, j_dist.build_device_state(jpg, problem))
        tex.prepare(tpg, t_dist.build_device_state(tpg, problem), device="cpu")
        for a, b in ((tex._color_dtype, jex._color_dtype),
                     (tex._slot_dtype, jex._slot_dtype)):
            assert str(a).split(".")[-1] == jnp.dtype(b).name, problem
    if node_size == 1:
        assert got.comm_bytes_intra == 0


@pytest.mark.parametrize("seed", [3, 11])
def test_every_exchange_on_random_partitions(seed):
    """repro's property test: random graphs, random partitions, every
    registered exchange (halo where the partition is a slab), d1/d2/pd2."""
    rng = np.random.default_rng(seed)
    n, deg, parts = int(rng.integers(8, 41)), int(rng.integers(1, 5)), int(rng.integers(1, 5))
    src, dst = rng.integers(0, n, n * deg), rng.integers(0, n, n * deg)
    jpg = j_partition(j_build_graph(src, dst, n), parts, strategy="random",
                      seed=seed, second_layer=True)
    tpg = t_partition(t_build_graph(src, dst, n), parts, strategy="random",
                      seed=seed, second_layer=True)
    for problem in ("d1", "d2", "pd2"):
        for name in t_ex.list_exchanges():
            if t_ex.get_exchange(name).requires_slab and not tpg.halo_neighbors_ok():
                continue
            got = t_dist.color_distributed(tpg, problem=problem, exchange=name,
                                           backend="cuda_fused", device="cpu")
            assert_same_result(got, _want(jpg, problem, name))


@pytest.mark.parametrize("exchange", ["sparse_delta", "hier_delta"])
def test_cuda_scatter_matches_pallas_scatter(exchange):
    """The kernel scatter path (its plain version on the CPU) against
    repro's Pallas pair_scatter in interpret mode, through the loop."""
    jg, tg = j_gen.hex_mesh(10, 6, 6), t_gen.hex_mesh(10, 6, 6)
    jpg, tpg = j_partition(jg, 4), t_partition(tg, 4)
    jcls = {"sparse_delta": j_ex.SparseDeltaExchange,
            "hier_delta": j_ex.HierDeltaExchange}[exchange]
    want = _want(jpg, "d1", jcls(scatter="pallas"))
    tex = t_ex.get_exchange(exchange)
    tex.scatter = "cuda"
    before = pair_scatter.launches
    got = t_dist.color_distributed(tpg, backend="cuda_fused", exchange=tex, device="cpu")
    assert_same_result(got, want)
    assert pair_scatter.launches == before        # the CPU runs no kernel


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_plan_warm_requests_match(exchange):
    """Exchange state restarts with every request of one plan."""
    jg = j_gen.hex_mesh(12, 8, 8)
    jpg, tpg = _flat("d1")
    jplan = j_build_plan(jpg, problem="d1", exchange=exchange, engine="simulate",
                         state_cache=False)
    tplan = ColoringPlan(tpg, backend="cuda_fused", exchange=exchange, device="cpu")
    prev = jplan.run()
    assert_same_result(tplan.run(), prev)
    rng = np.random.default_rng(7)
    for step in range(2):
        mask = rng.random(jg.n) < 0.2
        colors0 = prev.colors.copy()
        colors0[mask] = 0
        want = jplan.run(color_mask=mask, colors0=colors0)
        assert_same_result(tplan.run(color_mask=mask, colors0=colors0), want)
        prev = want


def test_stacked_exchanges_match_one_round():
    """One stacked exchange from random colors and carried state, ghosts
    and bytes equal to repro's, state carried into a second round."""
    jpg, tpg = _two_level()
    rng = np.random.default_rng(4)
    colors = [rng.integers(0, 9, (jpg.n_parts, jpg.n_local)).astype(np.int32)
              for _ in range(2)]
    colors[1][:, ::2] = colors[0][:, ::2]          # half unchanged
    for name in ("all_gather",) + EXCHANGES:
        jex, tex = j_ex.get_exchange(name), t_ex.get_exchange(name)
        jst = j_dist.build_device_state(jpg, "d2")
        jst.update(jex.prepare(jpg, jst))
        jst = {k: jnp.asarray(v) for k, v in jst.items()}
        tst = t_dist.build_device_state(tpg, "d2")
        tst.update(tex.prepare(tpg, tst, device="cpu"))
        tst = t_dist.state_to_torch(tst, "cpu")
        jstate, tstate = jex.init_state(jst), tex.init_state(tst)
        for c in colors:
            jg_, jb, jstate = jex.stacked(jst, jnp.asarray(c), jstate)
            tg_, tb, tstate = tex.stacked(tst, torch.from_numpy(c), tstate)
            np.testing.assert_array_equal(tg_.numpy(), np.asarray(jg_), err_msg=name)
            assert isinstance(tb, torch.Tensor) and tb.dtype == torch.int32, name
            np.testing.assert_array_equal(t_ex.level_split(tb).numpy(),
                                          np.asarray(j_ex.level_split(jb)), err_msg=name)


def test_pack_and_apply_pairs_match():
    rng = np.random.default_rng(9)
    p, d, s = 3, 4, 37
    take = rng.random((p, d, s)) < 0.3
    take[0, 1] = False                               # an empty buffer
    send = rng.integers(1, 20, (p, s)).astype(np.int32)
    import jax

    want = jax.vmap(lambda t, sd: jax.vmap(j_ex.pack_pairs, in_axes=(0, None))(t, sd))(
        jnp.asarray(take), jnp.asarray(send))
    got = t_ex.pack_pairs(torch.from_numpy(take), torch.from_numpy(send)[:, None, :])
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    table = rng.integers(0, 9, (p, d, s)).astype(np.int32)
    jtab = jax.vmap(jax.vmap(lambda t, i, c: j_ex.apply_pairs(t, i, c)))(
        jnp.asarray(table), want[0], want[1])
    for scatter in t_ex.SCATTERS:
        np.testing.assert_array_equal(
            t_ex.apply_pairs(torch.from_numpy(table), got[0], got[1],
                             scatter=scatter).numpy(), np.asarray(jtab))
    with pytest.raises(ValueError, match="scatter"):
        t_ex.apply_pairs(torch.from_numpy(table), got[0], got[1], scatter="pallas")


def test_payload_schema_matches():
    st = {"send_idx": np.zeros((4, 10), np.int32)}
    for bound in (0, 255, 256, 65535, 65536):
        tw, jw = t_ex.wire_dtype(bound), j_ex.wire_dtype(bound)
        assert str(tw).split(".")[-1] == jnp.dtype(jw).name
        assert t_ex.dtype_bytes(tw) == j_ex.dtype_bytes(jw)
    for bound in (-1,):
        for fn in (t_ex.wire_dtype, j_ex.wire_dtype):
            with pytest.raises(ValueError):
                fn(bound)
    for dt, size in ((np.uint8, 1), (np.uint16, 2), (np.int32, 4),
                     (torch.uint8, 1), (torch.uint16, 2), (torch.int32, 4)):
        assert t_ex.dtype_bytes(dt) == size
    cases = [dict(colors=3), dict(headers=2, pairs=5), dict(masks=2),
             dict(colors=3, headers=2, pairs=5, masks=1,
                  color_dtype=(torch.uint8, jnp.uint8),
                  slot_dtype=(torch.uint16, jnp.uint16))]
    for kw in cases:
        tkw = {k: v[0] if isinstance(v, tuple) else v for k, v in kw.items()}
        jkw = {k: v[1] if isinstance(v, tuple) else v for k, v in kw.items()}
        want = int(j_ex.payload_bytes(st, **jkw))
        assert int(t_ex.payload_bytes(st, **tkw)) == want
        # Tensor counts stay tensors (no host sync), int32, floor-divided.
        tt = {k: (torch.tensor(v, dtype=torch.int32) if isinstance(v, int) else v)
              for k, v in tkw.items()}
        got = t_ex.payload_bytes(st, **tt)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
        jt = {k: (jnp.asarray(v, jnp.int32) if isinstance(v, int) else v)
              for k, v in jkw.items()}
        assert int(got // 3) == int(j_ex.payload_bytes(st, **jt) // 3) == want // 3
    for v in (40, [7, 9]):
        np.testing.assert_array_equal(
            t_ex.level_split(torch.tensor(v, dtype=torch.int32)).numpy(),
            np.asarray(j_ex.level_split(jnp.asarray(v, jnp.int32))))


def test_registry_and_error_paths():
    assert t_ex.list_exchanges() == j_ex.list_exchanges()
    assert isinstance(t_ex.get_exchange("hier_delta"), t_ex.HierDeltaExchange)
    with pytest.raises(ValueError, match="unknown exchange"):
        t_ex.get_exchange("rdma")
    # halo rejects a partition that is not a slab, on every entry point.
    tg = t_gen.rmat(7, 5, seed=1)
    tpg = t_partition(tg, 4, strategy="random")
    assert not tpg.halo_neighbors_ok()
    with pytest.raises(ValueError, match="slab"):
        t_dist.color_distributed(tpg, exchange="halo", device="cpu")
    with pytest.raises(ValueError, match="slab"):
        ColoringPlan(tpg, exchange=t_ex.HaloExchange(), device="cpu")
    # The sparse strategies refuse to run without their prepare() tables.
    for cls in (t_ex.SparseDeltaExchange, t_ex.HierDeltaExchange):
        with pytest.raises(ValueError, match="prepare"):
            cls().init_state({"send_idx": np.zeros((2, 3))})
        with pytest.raises(ValueError, match="scatter"):
            cls(scatter="pallas")


def test_cli_exchanges(capsys):
    base = ["--graph", "hex:12,6,6", "--parts", "4", "--device", "cpu",
            "--problem", "d2", "--node-size", "2"]
    jpg, _ = _two_level()
    want = _want(jpg, "d2", "hier_delta")
    t_cli.main(base + ["--exchange", "hier_delta", "--backend", "cuda_fused"])
    out = capsys.readouterr().out
    assert "exchange=hier_delta" in out and "proper=True" in out
    assert f"comm_bytes_by_round={[int(b) for b in want.comm_bytes_by_round]}" in out
    assert (f"intra-node={want.comm_bytes_intra}B "
            f"inter-node={want.comm_bytes_inter}B") in out
    with pytest.raises(ValueError, match="slab"):
        t_cli.main(["--graph", "hex:12,6,6", "--parts", "4", "--device", "cpu",
                    "--exchange", "halo", "--strategy", "random"])
    with pytest.raises(SystemExit):
        t_cli.main(base + ["--exchange", "rdma"])
