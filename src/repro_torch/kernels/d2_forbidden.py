"""``d2_forbidden`` — net-based two-hop color assignment.

The CUDA kernel (``csrc/d2_forbidden.cu``) replaces the TPU kernel
``repro/kernels/d2_forbidden.py::d2_forbidden`` together with the pick of
``repro/kernels/ops.py::d2_assign_pallas``: the main path only ever uses
the mask to pick a color, so the kernel does both in one pass and
:func:`d2_assign` returns ``(new_colors, new_base)`` as ``vb_bit_assign``
does.  Two plain-PyTorch versions sit beside it:

* :func:`d2_forbidden_ref` — the mask alone, int64 holding uint32 values
  (the counterpart of ``repro/kernels/ref.py::d2_forbidden_ref``);
* :func:`d2_assign_ref` — that mask plus ``pick_color``, the plain
  version of the kernel.

All work on the stacked part axis: ``adj_cidx (P, N, W)``,
``ext_adj_cidx (P, T, W)`` (one adjacency row per color-table entry),
rows ``(P, N)``, table ``(P, T)``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.local import build_two_hop, forbidden_mask, gather_rows, pick_color
from repro_torch.kernels import check_tensor, on_cpu
from repro_torch.kernels.build import load

__all__ = ["d2_assign", "d2_assign_ref", "d2_forbidden_ref"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I64, _P, _I64, _P, _I64, _P, _P,
             _INT, _INT, _INT, _INT, _INT, _P]


def d2_forbidden_ref(adj_cidx, base, active, colors, color_tab, ext_adj_cidx, *,
                     partial_d2=False):
    """uint32 forbidden mask (as int64) over each row's window: the one-hop
    colors (unless ``partial_d2``) and the colors of every neighbor's row
    of ``ext_adj_cidx``."""
    colors = colors.to(torch.int32)
    uncolored = active.to(torch.bool) & (colors == 0)
    base_eff = torch.where(uncolored, base.to(torch.int32), 1)
    tab = color_tab.to(torch.int32)
    hop2 = gather_rows(tab, build_two_hop(adj_cidx, ext_adj_cidx))
    if partial_d2:
        all_colors = hop2
    else:
        all_colors = torch.cat([gather_rows(tab, adj_cidx), hop2], dim=-1)
    return forbidden_mask(all_colors, base_eff)


def d2_assign_ref(adj_cidx, ext_adj_cidx, color_tab, base, active, *,
                  partial_d2=False):
    """Plain version of :func:`d2_assign`."""
    n = active.shape[-1]
    colors = color_tab[:, :n].to(torch.int32)
    base = base.to(torch.int32)
    forbidden = d2_forbidden_ref(adj_cidx, base, active, colors, color_tab,
                                 ext_adj_cidx, partial_d2=partial_d2)
    uncolored = active.to(torch.bool) & (colors == 0)
    base_eff = torch.where(uncolored, base, 1)
    cand, ok = pick_color(forbidden, base_eff)
    new_colors = torch.where(uncolored & ok, cand, colors)
    new_base = torch.where(uncolored & ~ok, base + 32, base)
    return new_colors, new_base


def d2_assign(
    adj_cidx: torch.Tensor,       # (P, N, W) int32, contiguous
    ext_adj_cidx: torch.Tensor,   # (P, T, W) int32, contiguous
    color_tab: torch.Tensor,      # (P, T) int32; [:, :N] are the rows' colors
    base: torch.Tensor,           # (P, N) int32 window starts
    active: torch.Tensor,         # (P, N) bool
    *,
    partial_d2: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One distance-2 assignment step. Returns ``(new_colors, new_base)``.

    Every index in ``adj_cidx`` and ``ext_adj_cidx`` must lie in ``[0, T)``.
    """
    if on_cpu(adj_cidx, ext_adj_cidx, color_tab, base, active):
        return d2_assign_ref(adj_cidx, ext_adj_cidx, color_tab, base, active,
                             partial_d2=partial_d2)
    p, n, w = adj_cidx.shape
    t = color_tab.shape[-1]
    if n >= t:
        raise ValueError(f"color_tab: {t} entries cannot hold {n} rows and a pad slot")
    check_tensor(adj_cidx, "adj_cidx", torch.int32, (p, n, w), contiguous=True)
    check_tensor(ext_adj_cidx, "ext_adj_cidx", torch.int32, (p, t, w), contiguous=True)
    tps = check_tensor(color_tab, "color_tab", torch.int32, (p, t))
    bps = check_tensor(base, "base", torch.int32, (p, n))
    aps = check_tensor(active, "active", torch.bool, (p, n))
    dev = adj_cidx.device
    out_colors = torch.empty((p, n), dtype=torch.int32, device=dev)
    out_base = torch.empty((p, n), dtype=torch.int32, device=dev)
    fn = load("d2_forbidden").d2_assign_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(adj_cidx.data_ptr(), ext_adj_cidx.data_ptr(), base.data_ptr(), bps,
             active.data_ptr(), aps, color_tab.data_ptr(), tps,
             out_colors.data_ptr(), out_base.data_ptr(), p, n, t, w,
             int(partial_d2), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"d2_assign: kernel launch failed with CUDA error {err}")
    d2_assign.launches += 1
    return out_colors, out_base


d2_assign.launches = 0
