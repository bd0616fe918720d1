"""The card tests' new inputs, held against ``repro`` on the CPU.

The fused round's edge cases (``_testing.round_edge``: every row losing,
none losing, one part iterating long after the others) go through the
port's ``fused_round``, which takes its plain version on CPU tensors, and
through ``repro``'s Pallas ``fused_round`` in interpret mode, part by part,
with and without pairs; they must be equal.  The flash-attention shapes
added for the wgmma body (head width 80, lengths ragged against 128-row
tiles, causal with fewer and more queries than keys, batch * heads above
65,535) go through the port's plain version and ``repro``'s oracle in
float32.  ``test_torch_kernels_card.py`` holds the CUDA kernels to the
plain versions on the same inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.local as t_local
from repro.kernels import ops as j_ops
from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro_torch.kernels._testing import (
    FLASH_SHAPES, ROUND_EDGES, ROW_TOL, max_row_error, random_qkv, round_edge, round_pairs,
)
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention
from repro_torch.kernels.fused_round import fused_round

PARTS = 3
# The flash shapes added for the wgmma body (after the sweep, the grid of
# query groups and head widths, and the two causal Lq != Lk cases) and every
# dh-80 case, small enough for the CPU (at most 2**24 query elements).
NEW_FLASH = [s for i, s in enumerate(FLASH_SHAPES)
             if (i >= 4 + 48 + 2 or s[5] == 80) and s[0] * s[1] * s[3] * s[5] <= 2**24]


def _edge(name, n, w, g, pairs):
    adj, th, colors, ghost, deg, gid, bd = round_edge(name, n, w, g, n + PARTS, PARTS)
    slots, vals = round_pairs(g, n + 5, PARTS) if pairs else (None, None)
    return adj, th, colors, ghost, deg, gid, bd, slots, vals


@pytest.mark.parametrize("name,n,w,g", ROUND_EDGES)
@pytest.mark.parametrize("problem", ["d1", "d2", "pd2"])
@pytest.mark.parametrize("pairs", [False, True])
def test_round_edge_matches_repro_pallas(name, n, w, g, problem, pairs):
    adj, th, colors, ghost, deg, gid, bd, slots, vals = _edge(name, n, w, g, pairs)
    th = None if problem == "d1" else th

    def t(x):
        return None if x is None else torch.from_numpy(x)

    got = fused_round(*map(t, (adj, colors, ghost, deg, gid, bd, th, slots, vals)),
                      problem=problem)
    for p in range(PARTS):
        def j(x):
            return None if x is None else jnp.asarray(x[p])

        want = j_ops.fused_round(j(adj), j(colors), j(ghost), j(deg), j(gid), j(bd),
                                 two_hop_cidx=j(th), pair_slots=j(slots),
                                 pair_colors=j(vals), problem=problem, tile=64)
        for field, a, b in zip(("colors", "lose_v", "lose_ghost", "count"), got, want):
            np.testing.assert_array_equal(a[p].numpy(), np.asarray(b),
                                          err_msg=f"{name}/{problem}/{field}/part {p}")


@pytest.mark.parametrize("problem", ["d1", "d2"])
def test_round_edges_make_their_cases(monkeypatch, problem):
    """all_lose loses every row, none_lose none (colors unchanged), and in
    one_part_slow part 0 iterates at least three times as long as the
    parts that stop after their one loser."""
    def run(name, n, w, g):
        adj, th, colors, ghost, deg, gid, bd, _, _ = _edge(name, n, w, g, False)
        args = map(torch.from_numpy, (adj, colors, ghost, deg, gid, bd, th))
        *args, th_t = args
        return colors, fused_round(*args, th_t if problem != "d1" else None,
                                   problem=problem)

    cases = {name: (n, w, g) for name, n, w, g in ROUND_EDGES}
    _, (_, lose, _, _) = run("all_lose", *cases["all_lose"])
    assert bool(lose.all())
    colors, (new, lose, _, count) = run("none_lose", *cases["none_lose"])
    assert not bool(lose.any()) and int(count.sum()) == 0
    assert np.array_equal(new.numpy(), colors)

    running = []
    orig = t_local.iterate_parts

    def spy(step, tab, active, *, max_iters):
        n_loc = active.shape[-1]

        def counted(tab, base):
            running.append((active & (tab[:, :n_loc] == 0)).any(dim=1).tolist())
            return step(tab, base)
        return orig(counted, tab, active, max_iters=max_iters)

    monkeypatch.setattr(t_local, "iterate_parts", spy)
    _, (_, lose, _, _) = run("one_part_slow", *cases["one_part_slow"])
    assert lose.sum(dim=1).tolist()[1:] == [1] * (PARTS - 1)
    per_part = np.array(running).sum(axis=0)
    assert per_part[0] >= 3 * per_part[1:].max() and per_part[1:].max() == 1


@pytest.mark.parametrize("b,lq,lk,hq,hkv,dh,causal,bq,bk", NEW_FLASH, ids=str)
def test_new_flash_shapes_match_repro_oracle(b, lq, lk, hq, hkv, dh, causal, bq, bk):
    assert dh in HEAD_DIMS
    q, k, v = random_qkv(b, lq, lk, hq, hkv, dh, lq + dh)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal, block_q=bq,
                          block_k=bk)
    want = jax_flash_ref(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert max_row_error(got, torch.from_numpy(np.array(want))) <= ROW_TOL


def test_row_check_fails_a_dropped_late_key_tile():
    """An output whose last 128 rows leave out one 128-key tile passes
    rtol = atol = 2e-2 element by element (late rows average many keys, so
    their elements are small); the row check fails it."""
    n = 4096
    q, k, v = map(torch.from_numpy, random_qkv(1, n, n, 2, 1, 64, 3))
    q = q * 0.3                                  # flat softmax rows, as a served model's
    want = flash_attention(q, k, v, causal=True)
    kept = torch.ones(n, dtype=torch.bool)
    kept[1024:1152] = False                     # a tile of keys every late row sees
    dropped = flash_attention(q, k[:, kept], v[:, kept], causal=False)
    late = torch.zeros(n, dtype=torch.bool)
    late[n - 128:] = True
    got = torch.where(late[None, :, None, None], dropped, want)
    assert torch.allclose(got, want, rtol=2e-2, atol=2e-2)
    assert max_row_error(got, want) > ROW_TOL
