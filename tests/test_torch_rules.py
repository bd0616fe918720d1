"""Rule math of the port against ``repro``: hash, loser rule, masks, VB_BIT.

Integer math, so every comparison is exact equality.  Inputs are made
with numpy from a seed and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import conflict as j_conflict
from repro.core import local as j_local
from repro.core.distributed import build_device_state
from repro.graph.generators import hex_mesh, mycielskian, rmat
from repro.graph.partition import PAD_GID, partition_graph
from repro_torch.core import conflict as t_conflict
from repro_torch.core import local as t_local


def test_gid_hash_matches():
    rng = np.random.default_rng(0)
    gids = np.concatenate([
        np.array([0, 1, PAD_GID, 2**31 - 1, -1, -(2**31)], np.int32),
        rng.integers(-(2**31), 2**31, 4000, dtype=np.int64).astype(np.int32),
    ])
    want = np.asarray(j_conflict.gid_hash(jnp.asarray(gids))).astype(np.int64)
    got = t_conflict.gid_hash(torch.from_numpy(gids)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < 2**32


@pytest.mark.parametrize("recolor_degrees", [True, False])
def test_v_loses_matches(recolor_degrees):
    rng = np.random.default_rng(1)
    n = 5000
    cv, cu = (rng.integers(0, 4, n).astype(np.int32) for _ in range(2))
    dv, du = (rng.integers(0, 3, n).astype(np.int32) for _ in range(2))
    gv = rng.integers(0, 50, n).astype(np.int32)
    gu = np.where(rng.random(n) < 0.2, gv, rng.integers(0, 50, n)).astype(np.int32)
    args = (cv, cu, dv, du, gv, gu)
    want = j_conflict.v_loses(*map(jnp.asarray, args),
                              recolor_degrees=recolor_degrees)
    got = t_conflict.v_loses(*map(torch.from_numpy, args),
                             recolor_degrees=recolor_degrees)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


def test_forbidden_mask_matches():
    rng = np.random.default_rng(2)
    n, k = 600, 40
    nbr = rng.integers(0, 80, (n, k)).astype(np.int32)
    base = rng.integers(1, 60, n).astype(np.int32)
    nbr[0, :32] = np.arange(1, 33)      # full window at base 1
    base[0] = 1
    nbr[1] = 0                          # nothing forbidden
    want = np.asarray(j_local.forbidden_mask(jnp.asarray(nbr), jnp.asarray(base)))
    got = t_local.forbidden_mask(torch.from_numpy(nbr), torch.from_numpy(base))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert got[0] == 0xFFFFFFFF and got[1] == 0


def test_pick_color_matches_including_full_and_empty():
    rng = np.random.default_rng(3)
    masks = np.concatenate([
        np.array([0, 0xFFFFFFFF, 0x7FFFFFFF, 0xFFFFFFFE, 0x80000000, 1, 0xFFFF],
                 np.uint32),
        rng.integers(0, 2**32, 2000, dtype=np.uint64).astype(np.uint32),
        (np.uint32(1) << rng.integers(0, 32, 200).astype(np.uint32))
        - np.uint32(1),
    ])
    base = rng.integers(1, 100, masks.size).astype(np.int32)
    jc, jok = j_local.pick_color(jnp.asarray(masks), jnp.asarray(base))
    tc, tok = t_local.pick_color(torch.from_numpy(masks.astype(np.int64)),
                                 torch.from_numpy(base))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    ok = np.asarray(jok)
    np.testing.assert_array_equal(tc.numpy()[ok], np.asarray(jc)[ok])
    assert tc.dtype == torch.int32
    assert not tok[1] and tok[0] and tc[0] == base[0] and tc[2] == base[2] + 31


def _stacked_case(graph, parts, seed):
    """Partition state plus a random table: ghosts already colored, owned
    rows half pre-colored, a random active set."""
    pg = partition_graph(graph, parts, strategy="edge_balanced")
    st = build_device_state(pg, "d1")
    rng = np.random.default_rng(seed)
    p, nl, g = pg.n_parts, pg.n_local, pg.n_ghost
    tab = np.concatenate([
        np.where(rng.random((p, nl)) < 0.5, rng.integers(1, 6, (p, nl)), 0),
        rng.integers(0, 6, (p, g)), np.zeros((p, 1), np.int64)], axis=1).astype(np.int32)
    active = st["active0"] & (rng.random((p, nl)) < 0.7)
    return st["adj_cidx"], tab, active, st["deg_tab"], st["gid_tab"]


GRAPHS = {"hex": lambda: hex_mesh(8, 6, 6), "rmat": lambda: rmat(8, 6, seed=3),
          "myc": lambda: mycielskian(8)}


@pytest.mark.parametrize("gname", list(GRAPHS))
@pytest.mark.parametrize("recolor_degrees", [True, False])
@pytest.mark.parametrize("max_iters", [512, 2])
def test_local_color_d1_matches_per_part(gname, recolor_degrees, max_iters):
    """The stacked fixed point equals JAX run on each part alone,
    including the per-part iteration cap."""
    adj, tab, active, deg, gid = _stacked_case(GRAPHS[gname](), 3, seed=7)
    got = t_local.local_color_d1(
        *map(torch.from_numpy, (adj, tab, active, deg, gid)),
        recolor_degrees=recolor_degrees, max_iters=max_iters).numpy()
    want = jax.vmap(lambda a, t, ac, d, g_: j_local.local_color_d1(
        a, t, ac, d, g_, recolor_degrees=recolor_degrees, max_iters=max_iters))(
        *map(jnp.asarray, (adj, tab, active, deg, gid)))
    np.testing.assert_array_equal(got, np.asarray(want))
    for p in range(adj.shape[0]):
        solo = j_local.local_color_d1(
            *map(jnp.asarray, (adj[p], tab[p], active[p], deg[p], gid[p])),
            recolor_degrees=recolor_degrees, max_iters=max_iters)
        np.testing.assert_array_equal(got[p], np.asarray(solo))
