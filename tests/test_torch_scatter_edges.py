"""The plain versions of ``pair_scatter`` and ``collision`` against ``repro``
on the card tests' edge shapes.

``test_torch_kernels_card.py`` holds the CUDA kernels to these plain
versions on a card, on the same cases (``_testing.SCATTER_EDGES``,
``COLLISION_EDGES``): table views whose rows are not 16-byte aligned, one
row and many, ``C`` unlike ``S``, all pads and no pads for the scatter;
lane counts on both sides of the collision kernel's first lanes and lane
chunks, dense, sparse and empty lists, a stopped part and
asymmetric lanes for the test.  Here the wrappers run their plain versions
on CPU tensors and are held exactly against ``repro/kernels/ref.py``'s
``pair_scatter_ref`` row by row, and against the Algorithm-4 rule in
``jnp`` through ``repro/core/conflict.py::v_loses``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.conflict import v_loses as j_v_loses
from repro.kernels import ref as j_ref
from repro_torch.kernels._testing import (
    COLLISION_EDGES, SCATTER_EDGES, collision_lists_of, random_collision, scatter_edge,
)
from repro_torch.kernels.collision import collision_ref
from repro_torch.kernels.scatter import pair_scatter, pair_scatter_ref


@pytest.mark.parametrize("rows,s,c,k,ps,off", SCATTER_EDGES)
def test_pair_scatter_edges_match_repro(rows, s, c, k, ps, off):
    wide, slots, vals = scatter_edge(rows, s, c, k, ps, off, rows + s + c)
    view = torch.from_numpy(wide)[:, off:off + s]
    assert view.stride(0) == ps and view.is_contiguous() == (ps == s or rows == 1)
    t_slots, t_vals = torch.from_numpy(slots), torch.from_numpy(vals)
    want = np.stack([np.asarray(j_ref.pair_scatter_ref(
        jnp.asarray(wide[r, off:off + s]), jnp.asarray(slots[r]), jnp.asarray(vals[r])))
        for r in range(rows)])
    before = pair_scatter.launches
    for fn in (pair_scatter, pair_scatter_ref):
        got = fn(view, t_slots, t_vals)
        assert got.shape == (rows, s) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert pair_scatter.launches == before                # the CPU runs no kernel
    real = (slots >= 0) & (slots < s)
    if k == 0:
        np.testing.assert_array_equal(want, wide[:, off:off + s])
    if k == s == c:
        assert real.all()


def _want_collision(lanes, newc, tab, deg, gid, rows, cur, rd):
    """The test and commit of the listed rows by the ``jnp`` rule:
    ``(table, lose, rows left to color sorted, counts per part and total)``."""
    p, n = newc.shape
    e = rows.astype(np.int64)
    parts, r = e // n, e % n
    lanes = np.concatenate([x.reshape(p * n, -1)[e] for x in lanes], axis=1).astype(np.int64)
    table = tab.copy()
    table[:, :n] = newc
    pc = parts[:, None]
    nc = newc[parts, r]
    lost = np.asarray(j_v_loses(
        jnp.asarray(nc[:, None]), jnp.asarray(table[pc, lanes]),
        jnp.asarray(deg[parts, r][:, None]), jnp.asarray(deg[pc, lanes]),
        jnp.asarray(gid[parts, r][:, None]), jnp.asarray(gid[pc, lanes]),
        recolor_degrees=rd)).any(axis=1)
    running = cur[parts] > 0
    lost &= running
    c = np.where(lost, 0, nc)
    out = tab.copy()
    out[parts[running], r[running]] = c[running]
    left = running & (c == 0)
    counts = np.zeros(p + 2, np.int32)
    counts[:p] = np.bincount(parts[left], minlength=p)
    counts[p] = left.sum()
    return out, lost, np.sort(e[left]).astype(np.int32), counts


@pytest.mark.parametrize("n,wa,wb,g", COLLISION_EDGES)
@pytest.mark.parametrize("rd", [True, False])
def test_collision_edges_match_repro(n, wa, wb, g, rd):
    """Every edge shape on three parts (the last stopped), over a dense, a
    sparse (shuffled) and an empty list."""
    lanes_a, lanes_b, tab, active, deg, gid, newc, cur = random_collision(
        n, wa, wb, g, n + wa + wb, 3)
    assert cur[:2].all() and not cur[2]
    lanes = [x for x in (lanes_a, lanes_b) if x is not None]
    t = {name: torch.from_numpy(x) for name, x in
         (("a", lanes_a), ("newc", newc), ("deg", deg), ("gid", gid), ("cur", cur))}
    t_b = None if lanes_b is None else torch.from_numpy(lanes_b)
    for kind, rows in collision_lists_of(active, n).items():
        want = _want_collision(lanes, newc, tab, deg, gid, rows, cur, rd)
        out, nxt = torch.from_numpy(tab.copy()), torch.zeros(5, dtype=torch.int32)
        spare = torch.ones(5, dtype=torch.int32)
        left = torch.full((3 * n,), -1, dtype=torch.int32)
        lose = torch.ones(len(rows), dtype=torch.bool)
        collision_ref(t["a"], t_b, t["newc"], out, t["deg"], t["gid"], torch.from_numpy(rows),
                      t["cur"], nxt, spare, left, lose, recolor_degrees=rd)
        got = (out.numpy(), lose.numpy(), np.sort(left[:int(nxt[3])].numpy()), nxt.numpy())
        for name, a, b in zip(("table", "lose", "left", "counts"), got, want):
            np.testing.assert_array_equal(a, b, err_msg=f"{kind} list: {name}")
        assert not spare.any()
        if kind == "dense":
            assert want[1].any() and (~want[1]).any()

