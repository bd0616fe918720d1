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
from repro_torch.kernels._testing import SHAPES, random_stacked
from repro_torch.kernels.conflict import conflict_detect, conflict_detect_ref
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
