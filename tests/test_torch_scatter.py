"""The port's ``pair_scatter`` and ``fused_round``'s pair input against ``repro``.

``pair_scatter`` takes its plain version on CPU tensors; that is held
exactly against ``repro``'s Pallas ``pair_scatter`` (interpret mode) and
its ``pair_scatter_ref`` over the sizes of ``tests/test_kernels.py``, and
row by row on batched inputs.  ``fused_round`` with ``(slot, color)``
pairs is held against ``repro``'s ``fused_round_ref`` with the same pairs,
part by part, as ``tests/test_kernels.py::test_fused_round_pairs_d1_d2``
holds the Pallas kernel.  The CUDA kernels themselves are held to the
plain versions on a card by ``test_torch_kernels_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels._testing import SCATTER_SHAPES, random_pairs, round_pairs
from repro_torch.kernels.fused_round import fused_round, fused_round_ref
from repro_torch.kernels.scatter import pair_scatter, pair_scatter_ref
from test_torch_fused import ROUND_KEYS, _round_state


def _one_row(n, c, seed):
    """One row as tests/test_kernels.py::test_pair_scatter_sweep draws it."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 99, n).astype(np.int32)
    k = int(rng.integers(0, min(n, c) + 1))
    slots = np.full(c, n, np.int32)
    slots[:k] = rng.permutation(n)[:k]
    vals = rng.integers(1, 50, c).astype(np.int32)
    return table, slots, vals


@pytest.mark.parametrize("n,c", [(16, 5), (100, 100), (257, 64), (512, 1)])
@pytest.mark.parametrize("tile", [64, 256])
def test_pair_scatter_matches_pallas_and_ref(n, c, tile):
    table, slots, vals = _one_row(n, c, n + c + tile)
    want_k = j_ops.pair_scatter(jnp.asarray(table), jnp.asarray(slots),
                                jnp.asarray(vals), tile=tile)
    want_r = j_ref.pair_scatter_ref(jnp.asarray(table), jnp.asarray(slots),
                                    jnp.asarray(vals))
    np.testing.assert_array_equal(np.asarray(want_k), np.asarray(want_r))
    before = pair_scatter.launches
    t = [torch.from_numpy(x) for x in (table, slots, vals)]
    for fn in (pair_scatter, pair_scatter_ref, t_ops.pair_scatter):
        got = fn(*t)
        assert got.dtype == torch.int32 and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want_r))
    assert pair_scatter.launches == before        # the CPU runs no kernel
    np.testing.assert_array_equal(t[0].numpy(), table)   # functional


@pytest.mark.parametrize("rows,s,c,k", SCATTER_SHAPES)
def test_pair_scatter_batched_matches_ref_per_row(rows, s, c, k):
    table, slots, vals = random_pairs(rows, s, c, rows + s + c, k=k)
    got = pair_scatter(*(torch.from_numpy(x) for x in (table, slots, vals)))
    assert got.shape == (rows, s)
    for r in range(rows):
        want = j_ref.pair_scatter_ref(jnp.asarray(table[r]), jnp.asarray(slots[r]),
                                      jnp.asarray(vals[r]))
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want))
    if k == 0:
        np.testing.assert_array_equal(got.numpy(), table)
    # A leading axis of more than one dimension, as the stacked (P, P, S)
    # ghost tables have, scatters row by row as well.
    if rows % 2 == 0 and rows > 2:
        t3 = [torch.from_numpy(x).view(2, rows // 2, -1) for x in (table, slots, vals)]
        np.testing.assert_array_equal(pair_scatter(*t3).view(rows, s).numpy(),
                                      got.numpy())


@pytest.mark.parametrize("seed", range(4))
def test_pair_scatter_pairs_land_pads_drop(seed):
    """Pairs land, pads (slot >= S, and slot < 0 as the TPU kernel drops
    it) drop, untouched slots keep their value."""
    rng = np.random.default_rng(seed)
    n, c = int(rng.integers(4, 200)), int(rng.integers(1, 64))
    table, slots, vals = _one_row(n, c, seed)
    k = int((slots < n).sum())
    slots[k:] = rng.choice([n, n + 7, -1, -n], c - k)
    want = table.copy()
    want[slots[:k]] = vals[:k]
    got = pair_scatter(*(torch.from_numpy(x) for x in (table, slots, vals)))
    np.testing.assert_array_equal(got.numpy(), want)
    kern = j_ops.pair_scatter(jnp.asarray(table), jnp.asarray(slots),
                              jnp.asarray(vals), tile=64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(kern))


def test_pair_scatter_shape_errors():
    tab = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="one shape"):
        pair_scatter(tab, torch.zeros((2, 3), dtype=torch.int32),
                     torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="leading axes"):
        pair_scatter(tab, torch.zeros((3, 3), dtype=torch.int32),
                     torch.zeros((3, 3), dtype=torch.int32))


@pytest.mark.parametrize("problem", ["d1", "d2", "pd2"])
def test_fused_round_pairs_match_repro_ref(problem):
    """Inline pair scatter: (slot, color) updates land before detection,
    part by part equal to repro's fused_round_ref with the same pairs."""
    st, colors, ghost = _round_state(problem, seed=5)
    parts, g = ghost.shape
    slots, vals = round_pairs(g, 11, parts)
    th = st.get("two_hop_cidx")
    args = [torch.from_numpy(st[k]) for k in ROUND_KEYS]
    t_th = None if th is None else torch.from_numpy(th)
    pairs = (torch.from_numpy(slots), torch.from_numpy(vals))
    got = fused_round(args[0], torch.from_numpy(colors), torch.from_numpy(ghost),
                      *args[1:], t_th, *pairs, problem=problem)
    plain = fused_round_ref(args[0], torch.from_numpy(colors), torch.from_numpy(ghost),
                            *args[1:], t_th, *pairs, problem=problem)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    for p in range(parts):
        want = j_ref.fused_round_ref(
            jnp.asarray(st["adj_cidx"][p]), jnp.asarray(colors[p]),
            jnp.asarray(ghost[p]), jnp.asarray(st["deg_tab"][p]),
            jnp.asarray(st["gid_tab"][p]), jnp.asarray(st["is_boundary"][p]),
            two_hop_cidx=None if th is None else jnp.asarray(th[p]),
            pair_slots=jnp.asarray(slots[p]), pair_colors=jnp.asarray(vals[p]),
            ext_adj_cidx=None if th is None else jnp.asarray(st["ext_adj_cidx"][p]),
            problem=problem)
        for name, a, b in zip(("colors", "lose_v", "lose_ghost", "count"), got, want):
            np.testing.assert_array_equal(a[p].numpy(), np.asarray(b),
                                          err_msg=f"{problem}/{name}/part {p}")
    # The pairs changed the ghosts the round saw.
    no_pairs = fused_round(args[0], torch.from_numpy(colors), torch.from_numpy(ghost),
                           *args[1:], t_th, problem=problem)
    assert any(not torch.equal(a, b) for a, b in zip(got, no_pairs))


@pytest.mark.parametrize("problem", ["d1", "d2"])
def test_fused_round_pairs_rebuild_the_ghosts(problem):
    """Zero ghosts plus one pair per real ghost slot is the round on the
    ghosts themselves (chip_smoke.py times the kernel on such pairs)."""
    st, colors, ghost = _round_state(problem, seed=2)
    parts, g = ghost.shape
    args = [torch.from_numpy(st[k]) for k in ROUND_KEYS]
    th = None if problem == "d1" else torch.from_numpy(st["two_hop_cidx"])
    slots = torch.arange(g, dtype=torch.int32).repeat(parts, 1)
    slots[:, ::3] = g                               # some pads among them
    vals = torch.from_numpy(ghost).masked_fill(slots == g, 0)
    ghost_t = torch.from_numpy(ghost).masked_fill(slots != g, 0)
    got = fused_round(args[0], torch.from_numpy(colors), ghost_t, *args[1:], th,
                      slots, vals, problem=problem)
    want = fused_round(args[0], torch.from_numpy(colors), torch.from_numpy(ghost),
                       *args[1:], th, problem=problem)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_fused_round_pairs_come_together():
    st, colors, ghost = _round_state("d1")
    args = [torch.from_numpy(st[k]) for k in ROUND_KEYS]
    with pytest.raises(ValueError, match="together"):
        fused_round(args[0], torch.from_numpy(colors), torch.from_numpy(ghost),
                    *args[1:], None, torch.zeros((3, 2), dtype=torch.int32),
                    problem="d1")
