"""The port's local fixed points on lists of rows against ``repro``.

``kernels/ops.py::local_color_d1_cuda`` and ``local_color_d2_cuda`` run
their list bookkeeping on CPU tensors through the plain versions of the
``d2_forbidden`` and ``collision`` kernels; every result must equal
``repro``'s ``local_color_d1_pallas`` / ``local_color_d2_pallas``
(interpret mode) and ``core.local``'s, part by part, exactly.  The plain
list versions are held against the whole-table ones they restrict.
``test_torch_kernels_card.py`` holds the kernels to these on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as j_dist
from repro.core import local as j_local
from repro.graph import generators as j_gen
from repro.graph.partition import partition_graph as j_partition
from repro.kernels import ops as j_ops
from repro_torch.core import distributed as t_dist
from repro_torch.core import local as t_local
from repro_torch.core.plan import _resolve_engine
from repro_torch.graph import generators as t_gen
from repro_torch.graph.partition import partition_graph as t_partition
from repro_torch.kernels._testing import FIXED_POINT_SHAPES, random_fixed_point
from repro_torch.kernels.collision import collision, collision_lists
from repro_torch.kernels.d2_forbidden import d2_assign, d2_assign_ref
from repro_torch.kernels.ops import local_color_d1_cuda, local_color_d2_cuda
from test_torch_distributed import assert_same_result
from test_torch_kernels_card import _t

N, W, G = FIXED_POINT_SHAPES[0]


def _per_part(fn, arrays, p, **kw):
    return np.asarray(fn(*(jnp.asarray(a[p]) for a in arrays), **kw))


def _check_parts(got, arrays, fns, **kw):
    """``got`` equals each of ``fns`` on every part; returns how many parts
    changed from their input table."""
    tab = arrays[[i for i, a in enumerate(arrays) if a.ndim == 2][0]]
    for p in range(got.shape[0]):
        for fn in fns:
            np.testing.assert_array_equal(got[p].numpy(), _per_part(fn, arrays, p, **kw))
    return int((got.numpy() != tab).any(axis=1).sum())


def test_fixed_point_inputs_cover_the_edges():
    """Part 1 has active rows that collide with a ghost yet does not run;
    parts 0 and 2 run and stop at different iterations."""
    adj, ext, th, tab, active, deg, gid = _t(*random_fixed_point(N, W, G, 3, 3))
    lose = t_local.collision_losers(tab[:, :N], tab, adj, deg, gid, recolor_degrees=True)
    ghost = (adj >= N) & (adj < N + G)
    assert (lose & active)[1].any() and ghost.any()
    assert not (active & (tab[:, :N] == 0))[1].any()
    stops = []
    for p in (0, 2):
        one = [x[p:p + 1] for x in (adj, tab, active, deg, gid)]
        iters = [k for k in range(1, 20) if not (
            t_local.local_color_d1(*one, max_iters=k)[0, :N][active[p]] == 0).any()]
        stops.append(iters[0])
    assert stops[0] != stops[1]


@pytest.mark.parametrize("n,w,g", FIXED_POINT_SHAPES)
@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("partial_d2", [False, True])
def test_d2_assign_list_plain_matches_ref(n, w, g, parts, partial_d2):
    """The list form equals ``d2_assign_ref`` with ``active`` = the listed
    rows: every active uncolored row, a random subset, none."""
    adj, ext, _, tab, active, *_ = random_fixed_point(n, w, g, n, parts)
    todo = active & (tab[:, :n] == 0)
    rng = np.random.default_rng(n)
    base = rng.integers(1, 40, (parts, n)).astype(np.int32)
    for listed in (todo, todo & (rng.random(todo.shape) < 0.4), np.zeros_like(todo)):
        args = _t(adj, ext, tab)
        newc, b = _t(tab[:, :n].copy(), base.copy())
        rows = torch.from_numpy(np.flatnonzero(listed).astype(np.int32))
        assert d2_assign(*args, b, newc, rows, partial_d2=partial_d2) == (newc, b)
        want = d2_assign_ref(*args, torch.from_numpy(base), torch.from_numpy(listed),
                             partial_d2=partial_d2)
        assert torch.equal(newc, want[0]) and torch.equal(b, want[1])


@pytest.mark.parametrize("n,w,g", FIXED_POINT_SHAPES)
@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("blocks", ["one-hop", "two-hop", "both"])
@pytest.mark.parametrize("rd", [True, False])
def test_collision_plain_matches_collision_losers(n, w, g, parts, blocks, rd):
    """One iteration's test and commit over every active row equals
    ``collision_losers`` on the table holding the new colors, zeroed where
    an active row of a running part loses; a stopped part (the last, when
    there are three) is left alone.  Then the listing launch."""
    adj, ext, th, tab, active, deg, gid = _t(*random_fixed_point(n, w, g, n + 1, parts))
    p = parts
    newc = tab[:, :n].clone()
    todo = active & (newc == 0)
    newc[todo] = torch.from_numpy(np.random.default_rng(n).integers(0, 7, int(todo.sum()))
                                  .astype(np.int32))
    running = todo.any(dim=1)
    running[-1] = parts == 1
    cur = torch.zeros(p + 2, dtype=torch.int32)
    cur[:p] = running.to(torch.int32)
    lanes = {"one-hop": (adj, None), "two-hop": (th, None), "both": (th, adj)}[blocks]
    rows = torch.from_numpy(np.flatnonzero(active.numpy()).astype(np.int32))
    out, nxt = tab.clone(), torch.zeros(p + 2, dtype=torch.int32)
    spare = torch.ones(p + 2, dtype=torch.int32)
    left = torch.full((p * n,), -1, dtype=torch.int32)
    lose = torch.empty(len(rows), dtype=torch.bool)
    collision(*lanes, newc, out, deg, gid, rows, cur, nxt, spare, left, lose,
              recolor_degrees=rd)
    table = tab.clone()
    table[:, :n] = newc
    want_lose = torch.zeros_like(active)
    for blk in lanes:
        if blk is not None:
            want_lose |= t_local.collision_losers(newc, table, blk, deg, gid,
                                                  recolor_degrees=rd)
    want_lose &= active & running[:, None]
    want = tab.clone()
    want[:, :n] = torch.where(running[:, None] & active,
                              torch.where(want_lose, 0, newc), tab[:, :n])
    assert torch.equal(out, want)
    assert torch.equal(lose, want_lose.reshape(-1)[rows.long()])
    assert want_lose.any() and not spare.any()
    left_rows = running[:, None] & active & (want[:, :n] == 0)
    assert torch.equal(nxt[:p], left_rows.sum(dim=1).to(torch.int32))
    assert int(nxt[p]) == int(left_rows.sum())
    np.testing.assert_array_equal(left[:int(nxt[p])].numpy(), np.flatnonzero(left_rows))
    # The listing launch: the active rows, and the uncolored ones per part.
    listed, todo_rows = (torch.empty(p * n, dtype=torch.int32) for _ in range(2))
    counts = torch.zeros(p + 2, dtype=torch.int32)
    c, b = torch.empty_like(newc), torch.zeros_like(newc)
    collision_lists(active, tab, listed, todo_rows, counts, newc=c, base=b)
    assert torch.equal(listed[:int(counts[p + 1])], rows)
    np.testing.assert_array_equal(todo_rows[:int(counts[p])].numpy(), np.flatnonzero(todo))
    assert torch.equal(counts[:p], todo.sum(dim=1).to(torch.int32))
    assert torch.equal(c, tab[:, :n]) and torch.equal(b, active.to(torch.int32))


@pytest.mark.parametrize("partial_d2,rd,max_iters", [
    (False, True, 1024), (True, True, 1024), (False, False, 1024), (False, True, 1),
    (True, True, 2)])
def test_local_color_d2_cuda_matches_jax(partial_d2, rd, max_iters):
    """d2 and pd2 on three parts that stop at different iterations (one
    never runs), caps of 1 and 2, both ``recolor_degrees``: equal to
    ``local_color_d2_pallas`` and ``core.local.local_color_d2``."""
    adj, ext, th, tab, active, deg, gid = random_fixed_point(N, W, G, 5, 3)
    kw = dict(partial_d2=partial_d2, recolor_degrees=rd, max_iters=max_iters)
    before = tab.copy()
    got = local_color_d2_cuda(*_t(adj, th, ext, tab, active, deg, gid), **kw)
    assert np.array_equal(tab, before)      # the caller's table is left as it was
    assert torch.equal(got, t_local.local_color_d2(*_t(adj, th, tab, active, deg, gid),
                                                   **kw))
    changed = _check_parts(got, (adj, th, ext, tab, active, deg, gid),
                           [j_ops.local_color_d2_pallas], **kw)
    _check_parts(got, (adj, th, tab, active, deg, gid), [j_local.local_color_d2], **kw)
    assert changed == 2 and torch.equal(got[1], torch.from_numpy(tab[1]))


@pytest.mark.parametrize("rd,max_iters", [(True, 512), (False, 512), (True, 1), (True, 2)])
def test_local_color_d1_cuda_matches_jax(rd, max_iters):
    adj, _, _, tab, active, deg, gid = random_fixed_point(N, W, G, 6, 3)
    kw = dict(recolor_degrees=rd, max_iters=max_iters)
    before = tab.copy()
    got = local_color_d1_cuda(*_t(adj, tab, active, deg, gid), **kw)
    assert np.array_equal(tab, before)
    assert torch.equal(got, t_local.local_color_d1(*_t(adj, tab, active, deg, gid), **kw))
    changed = _check_parts(got, (adj, tab, active, deg, gid),
                           [j_ops.local_color_d1_pallas, j_local.local_color_d1], **kw)
    assert changed == 2 and torch.equal(got[1], torch.from_numpy(tab[1]))


def test_local_color_d1_cuda_full_table_matches_jax():
    """d1_2gl's call: the whole (P, N+G+1) table over the extended adjacency,
    ghosts active and the pad row inactive (``core/distributed.py``)."""
    pg = j_partition(j_gen.rmat(7, 5, seed=11), 3, second_layer=True)
    st = j_dist.build_device_state(pg, "d1_2gl")
    t = pg.n_local + pg.n_ghost + 1
    rng = np.random.default_rng(2)
    tab = np.where(rng.random((3, t)) < 0.5, rng.integers(1, 5, (3, t)), 0).astype(np.int32)
    tab[:, -1] = 0
    active = np.concatenate([st["active0"], rng.random((3, pg.n_ghost)) < 0.5,
                             np.zeros((3, 1), bool)], axis=1)
    arrays = (st["ext_adj_cidx"], tab, active, st["deg_tab"], st["gid_tab"])
    got = local_color_d1_cuda(*_t(*arrays))
    assert got.shape == (3, t) and int(got[:, -1].abs().sum()) == 0
    _check_parts(got, arrays, [j_ops.local_color_d1_pallas, j_local.local_color_d1])


def test_engine_auto_matches_repro():
    """``engine="auto"`` resolves as ``repro``'s ``_resolve_engine`` does:
    on one device of the plan's type, four parts run on ``simulate``.  An
    explicit ``"shard_map"`` without a process group raises, naming it."""
    jpg = j_partition(j_gen.hex_mesh(6, 4, 4), 4)
    tpg = t_partition(t_gen.hex_mesh(6, 4, 4), 4)
    want = j_dist.color_distributed(jpg, problem="d1", backend="reference",
                                    engine="auto", exchange="all_gather", cache=False)
    got = t_dist.color_distributed(tpg, problem="d1", backend="reference", engine="auto",
                                   exchange="all_gather", device="cpu")
    assert_same_result(got, want)
    with pytest.raises(ValueError, match="shard_map.*process group"):
        t_dist.color_distributed(tpg, engine="shard_map", device="cpu")


def test_resolve_engine(monkeypatch):
    """``"auto"`` gives ``"simulate"`` without a process group even where
    ``repro`` would pick ``shard_map`` (eight cards for four parts): the
    port's multi-GPU engine counts ranks, not cards.  An explicit name is
    kept as it is."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert _resolve_engine("auto", 4) == "simulate"
    assert _resolve_engine("simulate", 4) == "simulate"
    assert _resolve_engine("shard_map", 4) == "shard_map"
