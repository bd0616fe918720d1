"""The port's CUDA kernels against their plain versions, on a card.

Marked ``cuda``: each test skips where there is no card or no ``nvcc``.
The file imports neither jax nor ``repro``, so it also runs on a machine
with a card and no JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_card.py

Inputs come from ``repro_torch.kernels._testing``, drawn per part as
``tests/test_kernels.py`` draws them; ``chip_smoke.py`` uses the same.
"""
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.core.local import local_color_d1, local_color_d2
from repro_torch.kernels._testing import (
    COLLISION_EDGES, D2_SHAPES, FIXED_POINT_SHAPES, FLASH_SHAPES, ROUND_EDGES, ROUND_SHAPES,
    ROW_TOL, SCATTER_EDGES, SCATTER_SHAPES, SHAPES, collision_lists_of, max_row_error,
    random_collision, random_ext, random_fixed_point, random_pairs, random_qkv, random_round,
    random_stacked, round_edge, round_pairs, scatter_edge,
)
from repro_torch.kernels.collision import (
    collision, collision_lists, collision_lists_ref, collision_ref,
)
from repro_torch.kernels.conflict import conflict_detect, conflict_detect_ref
from repro_torch.kernels.d2_forbidden import d2_assign, d2_assign_list_ref
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.fused_round import fused_round, fused_round_ref
from repro_torch.kernels.ops import local_color_d1_cuda, local_color_d2_cuda
from repro_torch.kernels.scatter import pair_scatter, pair_scatter_ref
from repro_torch.kernels.vb_bit import vb_bit_assign, vb_bit_assign_ref


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    if build.nvcc_path() is None:
        pytest.skip("needs nvcc to build the CUDA kernels")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,g", SHAPES + [(300, 5, 0)])
@pytest.mark.parametrize("parts", [1, 3])
def test_vb_bit_kernel_matches_plain(card, n, w, g, parts):
    _, (adj, tab, base, active, *_) = random_stacked(n, w, g, 60, n, parts)
    adj, tab, base, active = _t(adj, tab, base, active, device=card)
    before = vb_bit_assign.launches
    got = vb_bit_assign(adj, tab[:, :n], base, active, tab)
    want = vb_bit_assign_ref(adj, tab[:, :n], base, active, tab)
    torch.cuda.synchronize()
    assert vb_bit_assign.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,g", SHAPES + [(300, 5, 0)])
@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("rd", [True, False])
def test_conflict_kernel_matches_plain(card, n, w, g, parts, rd):
    _, (adj, tab, _, _, deg, gid, bd) = random_stacked(n, w, g, 6, n, parts)
    adj, tab, deg, gid, bd = _t(adj, tab, deg, gid, bd, device=card)
    args = (adj, tab[:, :n], deg[:, :n], gid[:, :n], bd, tab, deg, gid, n)
    before = conflict_detect.launches
    got = conflict_detect(*args, recolor_degrees=rd)
    want = conflict_detect_ref(*args, recolor_degrees=rd)
    torch.cuda.synchronize()
    assert conflict_detect.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,g", D2_SHAPES + [(515, 6, 200)])
@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("partial_d2", [False, True])
def test_d2_assign_kernel_matches_plain(card, n, w, g, parts, partial_d2):
    """The list form on every row, a random subset of rows, and none."""
    _, (adj, tab, base, active, *_) = random_stacked(n, w, g, 20, n * 7, parts)
    args = _t(adj, random_ext(n, w, g, n, parts), tab, device=card)
    rng = torch.Generator().manual_seed(n)
    for listed in (torch.arange(parts * n), torch.randperm(parts * n, generator=rng)[:n // 2],
                   torch.arange(0)):
        rows = listed.to(torch.int32).to(card)
        got = _t(base, tab[:, :n].copy(), device=card)
        want = [x.clone() for x in got]
        before = d2_assign.launches
        d2_assign(*args, *got, rows, partial_d2=partial_d2)
        d2_assign_list_ref(*args, *want, rows, partial_d2=partial_d2)
        torch.cuda.synchronize()
        assert d2_assign.launches == before + (len(rows) > 0)   # an empty list launches nothing
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _collision_case(n, w, g, parts, card, rng):
    """A fixed point's state after an assignment: new colors on the active
    uncolored rows of random_fixed_point's tables, every part running but
    the last of three."""
    adj, ext, th, tab, active, deg, gid = _t(*random_fixed_point(n, w, g, n + 1, parts),
                                             device=card)
    newc = tab[:, :n].clone()
    todo = active & (newc == 0)
    newc[todo] = torch.randint(0, 7, (int(todo.sum()),), generator=rng).to(card, torch.int32)
    cur = torch.zeros(parts + 2, dtype=torch.int32, device=card)
    cur[:parts] = todo.any(dim=1).to(torch.int32)
    if parts == 3:
        cur[2] = 0
    return adj, th, tab, active, deg, gid, newc, cur


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,g", FIXED_POINT_SHAPES + [(64, 33, 9)])
@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("blocks", ["one-hop", "two-hop", "both"])
@pytest.mark.parametrize("rd", [True, False])
def test_collision_kernel_matches_plain(card, n, w, g, parts, blocks, rd):
    """Every active row listed, a list with part 0's rows left out, and an
    empty list: the table, the verdicts, the counts and the rows left to
    color (as sets: the kernel fills its list through atomics)."""
    rng = torch.Generator().manual_seed(n + parts)
    adj, th, tab, active, deg, gid, newc, cur = _collision_case(n, w, g, parts, card, rng)
    lanes = {"one-hop": (adj, None), "two-hop": (th, None), "both": (th, adj)}[blocks]
    every = torch.nonzero(active.reshape(-1))[:, 0].to(torch.int32)
    for rows in (every, every[every >= n], every[:0]):
        outs = []
        for fn in (collision, collision_ref):
            out = [tab.clone(), torch.zeros_like(cur), torch.ones_like(cur),
                   torch.full((parts * n,), -1, dtype=torch.int32, device=card),
                   torch.ones(len(rows), dtype=torch.bool, device=card)]
            before = collision.launches
            fn(*lanes, newc, out[0], deg, gid, rows, cur, *out[1:], recolor_degrees=rd)
            torch.cuda.synchronize()
            assert collision.launches == before + (fn is collision)
            out[3] = out[3][:int(out[1][parts])].sort().values
            outs.append(out)
        for a, b in zip(*outs):
            assert torch.equal(a, b)
        assert not outs[0][2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("n,wa,wb,g", COLLISION_EDGES)
@pytest.mark.parametrize("rd", [True, False])
def test_collision_kernel_edges_match_plain(card, n, wa, wb, g, rd):
    """Lane counts on both sides of the kernel's first lanes and lane
    chunks, on three parts (the last stopped) with asymmetric lanes, over a
    dense, a sparse (shuffled) and an empty list."""
    drawn = random_collision(n, wa, wb, g, n + wa + wb, 3)
    lanes_a, lanes_b, tab, active, deg, gid, newc, cur = (
        None if x is None else torch.from_numpy(x).to(card) for x in drawn)
    for kind, listed in collision_lists_of(drawn[3], n).items():
        rows = torch.from_numpy(listed).to(card)
        outs = []
        before = collision.launches
        for fn in (collision, collision_ref):
            out = [tab.clone(), torch.zeros_like(cur), torch.ones_like(cur),
                   torch.full((3 * n,), -1, dtype=torch.int32, device=card),
                   torch.ones(len(rows), dtype=torch.bool, device=card)]
            fn(lanes_a, lanes_b, newc, out[0], deg, gid, rows, cur, *out[1:],
               recolor_degrees=rd)
            torch.cuda.synchronize()
            out[3] = out[3][:int(out[1][3])].sort().values
            outs.append(out)
        assert collision.launches == before + 1
        for name, a, b in zip(("table", "counts", "spare", "left", "lose"), *outs):
            assert torch.equal(a, b), f"{kind} list: {name}"


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,g,parts", [(*shape, parts) for shape in FIXED_POINT_SHAPES
                                         for parts in (1, 3)] + [(8, 3, 4, 1100)])
def test_collision_lists_kernel_matches_plain(card, n, w, g, parts):
    """Also with more parts than the listing launch counts in shared memory."""
    _, _, _, tab, active, *_ = _t(*random_fixed_point(n, w, g, n, parts), device=card)
    outs = []
    for fn in (collision_lists, collision_lists_ref):
        rows, todo = (torch.full((parts * n,), -1, dtype=torch.int32, device=card)
                      for _ in range(2))
        counts = torch.zeros(parts + 2, dtype=torch.int32, device=card)
        newc, base = (torch.zeros((parts, n), dtype=torch.int32, device=card)
                      for _ in range(2))
        before = collision.launches
        fn(active, tab, rows, todo, counts, newc=newc, base=base)
        torch.cuda.synchronize()
        assert collision.launches == before + (fn is collision_lists)
        outs.append((rows[:int(counts[parts + 1])].sort().values,
                     todo[:int(counts[parts])].sort().values, counts, newc, base))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,g", FIXED_POINT_SHAPES)
@pytest.mark.parametrize("problem", ["d1", "d2", "pd2"])
@pytest.mark.parametrize("rd", [True, False])
@pytest.mark.parametrize("max_iters", [1, 2, None])
def test_fixed_points_match_plain_on_card(card, n, w, g, problem, rd, max_iters):
    """The kernel-backed fixed points equal core/local.py's on the card, on
    three parts that stop at different iterations (one never runs)."""
    adj, ext, th, tab, active, deg, gid = _t(*random_fixed_point(n, w, g, n + 2, 3),
                                             device=card)
    kw = dict(recolor_degrees=rd)
    if max_iters is not None:
        kw["max_iters"] = max_iters
    launches, before = collision.launches, tab.clone()
    if problem == "d1":
        got = local_color_d1_cuda(adj, tab, active, deg, gid, **kw)
        want = local_color_d1(adj, tab, active, deg, gid, **kw)
    else:
        kw["partial_d2"] = problem == "pd2"
        got = local_color_d2_cuda(adj, th, ext, tab, active, deg, gid, **kw)
        want = local_color_d2(adj, th, tab, active, deg, gid, **kw)
    torch.cuda.synchronize()
    assert collision.launches >= launches + 2
    assert torch.equal(got, want) and torch.equal(tab, before)


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,g,real", ROUND_SHAPES)
@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("problem", ["d1", "d2", "pd2"])
@pytest.mark.parametrize("rd", [True, False])
def test_fused_round_kernel_matches_plain(card, n, w, g, real, parts, problem, rd):
    adj, th, colors, ghost, deg, gid, bd = _t(
        *random_round(n, w, g, n + parts, parts, real_ghosts=real), device=card)
    th = None if problem == "d1" else th
    kw = dict(problem=problem, recolor_degrees=rd)
    before = fused_round.launches
    got = fused_round(adj, colors, ghost, deg, gid, bd, th, **kw)
    want = fused_round_ref(adj, colors, ghost, deg, gid, bd, th, **kw)
    torch.cuda.synchronize()
    assert fused_round.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,s,c,k", SCATTER_SHAPES)
def test_pair_scatter_kernel_matches_plain(card, rows, s, c, k):
    table, slots, vals = _t(*random_pairs(rows, s, c, rows + s + c, k=k), device=card)
    before = pair_scatter.launches
    got = pair_scatter(table, slots, vals)
    want = pair_scatter_ref(table, slots, vals)
    torch.cuda.synchronize()
    assert pair_scatter.launches == before + 1
    assert torch.equal(got, want)
    # A table strided over its rows (every other row of a wider one).
    wide = torch.zeros((rows, 2 * s), dtype=torch.int32, device=card)
    wide[:, :s] = table
    assert torch.equal(pair_scatter(wide[:, :s], slots, vals), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,g,real", ROUND_SHAPES)
@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("problem", ["d1", "d2", "pd2"])
def test_fused_round_pairs_kernel_matches_plain(card, n, w, g, real, parts, problem):
    adj, th, colors, ghost, deg, gid, bd = _t(
        *random_round(n, w, g, n + parts, parts, real_ghosts=real), device=card)
    slots, vals = _t(*round_pairs(g, n + 11, parts), device=card)
    th = None if problem == "d1" else th
    before = fused_round.launches
    got = fused_round(adj, colors, ghost, deg, gid, bd, th, slots, vals, problem=problem)
    want = fused_round_ref(adj, colors, ghost, deg, gid, bd, th, slots, vals,
                           problem=problem)
    torch.cuda.synchronize()
    assert fused_round.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name,n,w,g", ROUND_EDGES)
@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("problem", ["d1", "d2", "pd2"])
@pytest.mark.parametrize("pairs", [False, True])
def test_fused_round_kernel_edges_match_plain(card, name, n, w, g, parts, problem, pairs):
    """Every row losing, none losing (an empty list of rows to recolor),
    and one part iterating long after the others stopped."""
    adj, th, colors, ghost, deg, gid, bd = _t(
        *round_edge(name, n, w, g, n + parts, parts), device=card)
    extra = _t(*round_pairs(g, n + 5, parts), device=card) if pairs else []
    th = None if problem == "d1" else th
    before = fused_round.launches
    got = fused_round(adj, colors, ghost, deg, gid, bd, th, *extra, problem=problem)
    want = fused_round_ref(adj, colors, ghost, deg, gid, bd, th, *extra, problem=problem)
    torch.cuda.synchronize()
    assert fused_round.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_kernel_matches_plain(card, monkeypatch, shape, dtype):
    """Against the fp32 plain version of the same (rounded) inputs: 2e-5 in
    fp32 (sums in another order), 2e-2 in bf16 (the output rounds to bf16),
    as tests/test_extensions.py holds the TPU kernel; and every output row
    within ROW_TOL of its norm, which a dropped or mis-masked key tile in
    late rows fails."""
    b, lq, lk, hq, hkv, dh, causal, bq, bk = shape
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = (t.to(dtype) for t in _t(*random_qkv(b, lq, lk, hq, hkv, dh, lq + dh),
                                        device=card))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    want = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    assert max_row_error(got, want) <= ROW_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("rows,s,c,k,ps,off", SCATTER_EDGES)
def test_pair_scatter_kernel_edges_match_plain(card, rows, s, c, k, ps, off):
    """Table views whose rows are not 16-byte aligned, one row and many, C
    unlike S, all pads and every slot real."""
    wide, slots, vals = _t(*scatter_edge(rows, s, c, k, ps, off, rows + s + c), device=card)
    table = wide[:, off:off + s]
    before, kept = pair_scatter.launches, wide.clone()
    got = pair_scatter(table, slots, vals)
    torch.cuda.synchronize()
    assert pair_scatter.launches == before + 1
    assert torch.equal(got, pair_scatter_ref(table, slots, vals))
    assert torch.equal(wide, kept)
