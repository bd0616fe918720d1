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
from repro_torch.kernels._testing import (
    D2_SHAPES, FLASH_SHAPES, ROUND_SHAPES, SCATTER_SHAPES, SHAPES, random_ext,
    random_pairs, random_qkv, random_round, random_stacked, round_pairs,
)
from repro_torch.kernels.conflict import conflict_detect, conflict_detect_ref
from repro_torch.kernels.d2_forbidden import d2_assign, d2_assign_ref
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.fused_round import fused_round, fused_round_ref
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
    _, (adj, tab, base, active, *_) = random_stacked(n, w, g, 20, n * 7, parts)
    args = _t(adj, random_ext(n, w, g, n, parts), tab, base, active, device=card)
    before = d2_assign.launches
    got = d2_assign(*args, partial_d2=partial_d2)
    want = d2_assign_ref(*args, partial_d2=partial_d2)
    torch.cuda.synchronize()
    assert d2_assign.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_kernel_matches_plain(card, monkeypatch, shape, dtype):
    """Against the fp32 plain version of the same (rounded) inputs: 2e-5 in
    fp32 (sums in another order), 2e-2 in bf16 (the output rounds to bf16),
    as tests/test_extensions.py holds the TPU kernel."""
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
