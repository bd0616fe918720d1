"""``vb_bit`` — windowed forbidden-bitmask color assignment.

The CUDA kernel (``csrc/vb_bit.cu``) replaces the TPU kernel
``repro/kernels/vb_bit.py::vb_bit_assign``; :func:`vb_bit_assign_ref` is
its plain-PyTorch version, the counterpart of
``repro/kernels/ref.py::vb_bit_assign_ref``.  Both work on the stacked
part axis: ``adj_cidx (P, N, W)``, rows ``(P, N)``, table ``(P, T)``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.local import forbidden_mask, gather_rows, pick_color
from repro_torch.kernels import check_tensor, on_cpu
from repro_torch.kernels.build import load

__all__ = ["vb_bit_assign", "vb_bit_assign_ref"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_ARGTYPES = [_P, _P, _I64, _P, _I64, _P, _I64, _P, _I64, _P, _P,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]


def vb_bit_assign_ref(adj_cidx, colors, base, active, color_tab):
    """Plain version of :func:`vb_bit_assign`."""
    colors = colors.to(torch.int32)
    base = base.to(torch.int32)
    uncolored = active.to(torch.bool) & (colors == 0)
    base_eff = torch.where(uncolored, base, 1)
    nbr_colors = gather_rows(color_tab.to(torch.int32), adj_cidx)
    cand, ok = pick_color(forbidden_mask(nbr_colors, base_eff), base_eff)
    new_colors = torch.where(uncolored & ok, cand, colors)
    new_base = torch.where(uncolored & ~ok, base + 32, base)
    return new_colors, new_base


def vb_bit_assign(
    adj_cidx: torch.Tensor,    # (P, N, W) int32, contiguous
    colors: torch.Tensor,      # (P, N) int32 current colors of these rows
    base: torch.Tensor,        # (P, N) int32 window starts
    active: torch.Tensor,      # (P, N) bool
    color_tab: torch.Tensor,   # (P, T) int32 colors of everything referenceable
) -> tuple[torch.Tensor, torch.Tensor]:
    """One VB_BIT assignment step. Returns ``(new_colors, new_base)``.

    Every index in ``adj_cidx`` must lie in ``[0, T)``.
    """
    if on_cpu(adj_cidx, colors, base, active, color_tab):
        return vb_bit_assign_ref(adj_cidx, colors, base, active, color_tab)
    p, n, w = adj_cidx.shape
    t = color_tab.shape[-1]
    check_tensor(adj_cidx, "adj_cidx", torch.int32, (p, n, w), contiguous=True)
    cps = check_tensor(colors, "colors", torch.int32, (p, n))
    bps = check_tensor(base, "base", torch.int32, (p, n))
    aps = check_tensor(active, "active", torch.bool, (p, n))
    tps = check_tensor(color_tab, "color_tab", torch.int32, (p, t))
    out_colors = torch.empty((p, n), dtype=torch.int32, device=adj_cidx.device)
    out_base = torch.empty((p, n), dtype=torch.int32, device=adj_cidx.device)
    fn = load("vb_bit").vb_bit_assign_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(adj_cidx.data_ptr(), colors.data_ptr(), cps, base.data_ptr(), bps,
             active.data_ptr(), aps, color_tab.data_ptr(), tps,
             out_colors.data_ptr(), out_base.data_ptr(), p, n, w,
             torch.cuda.current_stream(adj_cidx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vb_bit_assign: kernel launch failed with CUDA error {err}")
    vb_bit_assign.launches += 1
    return out_colors, out_base


vb_bit_assign.launches = 0
