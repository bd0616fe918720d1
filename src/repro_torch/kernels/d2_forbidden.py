"""``d2_forbidden`` — net-based two-hop color assignment over a list of rows.

The CUDA kernel (``csrc/d2_forbidden.cu``) replaces the TPU kernel
``repro/kernels/d2_forbidden.py::d2_forbidden`` together with the pick of
``repro/kernels/ops.py::d2_assign_pallas``: the main path only ever uses
the mask to pick a color, so the kernel does both in one pass.  It walks
a list of the rows to color (entries ``p * N + r``) and writes their new
color and window base into ``newc`` and ``base`` in place; rows that are
not listed are not touched.  Three plain-PyTorch versions sit beside it:

* :func:`d2_forbidden_ref` — the mask alone over every row, int64 holding
  uint32 values (the counterpart of ``repro/kernels/ref.py::d2_forbidden_ref``);
* :func:`d2_assign_ref` — that mask plus ``pick_color`` over every row,
  ``(new_colors, new_base)``, the counterpart of ``d2_assign_pallas``;
* :func:`d2_assign_list_ref` — :func:`d2_assign_ref` restricted to the
  listed rows, the plain version of the kernel.

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

__all__ = ["d2_assign", "d2_assign_list_ref", "d2_assign_ref", "d2_forbidden_ref",
           "launch_kernel"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I64, _P, _I64, _P, _P, _INT, _INT, _INT, _INT, _INT, _P]


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
    """One assignment step over every row: ``(new_colors, new_base)``; an
    active uncolored row takes its pick, every other row keeps its color
    and base."""
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


def d2_assign_list_ref(adj_cidx, ext_adj_cidx, color_tab, base, newc, rows, *,
                       partial_d2=False):
    """Plain version of :func:`d2_assign`: :func:`d2_assign_ref`'s pick at
    the listed rows, taken as uncolored, stored into ``newc`` and ``base``."""
    p, n, w = adj_cidx.shape
    e = rows.to(torch.int64)
    part = (e // n)[:, None]
    lanes = adj_cidx.reshape(p * n, w)[e].to(torch.int64)               # (L, W)
    tab = color_tab.to(torch.int32)
    colors = tab[part, ext_adj_cidx[part, lanes].reshape(len(e), w * w).to(torch.int64)]
    if not partial_d2:
        colors = torch.cat([tab[part, lanes], colors], dim=-1)
    b = base.view(-1)[e]
    cand, ok = pick_color(forbidden_mask(colors, b), b)
    newc.view(-1)[e] = torch.where(ok, cand, 0)
    base.view(-1)[e] = torch.where(ok, b, b + 32)
    return newc, base


def d2_assign(
    adj_cidx: torch.Tensor,       # (P, N, W) int32, contiguous
    ext_adj_cidx: torch.Tensor,   # (P, T, W) int32, contiguous
    color_tab: torch.Tensor,      # (P, T) int32 iteration-start colors
    base: torch.Tensor,           # (P, N) int32 window starts, contiguous
    newc: torch.Tensor,           # (P, N) int32 new colors, contiguous
    rows: torch.Tensor,           # (L,) int32 entries p * N + r, each once
    *,
    partial_d2: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One distance-2 assignment step over the listed rows, which are taken
    as uncolored: their new color and window base go into ``newc`` and
    ``base`` in place.  Returns ``(newc, base)``.

    Every index in ``adj_cidx`` and ``ext_adj_cidx`` must lie in ``[0, T)``.
    """
    args = (adj_cidx, ext_adj_cidx, color_tab, base, newc, rows)
    if on_cpu(*args):
        return d2_assign_list_ref(*args, partial_d2=partial_d2)
    if launch_kernel(load("d2_forbidden"), *args, partial_d2=partial_d2):
        d2_assign.launches += 1
    return newc, base


def launch_kernel(lib, adj_cidx, ext_adj_cidx, color_tab, base, newc, rows, *,
                  partial_d2=False) -> bool:
    """One call of ``lib``'s ``d2_assign_list_launch`` on CUDA tensors, as
    :func:`d2_assign` makes it; counts no launch.  Returns whether the
    kernel was launched (an empty list launches nothing).  ``lib`` is the
    loaded library of ``csrc/d2_forbidden.cu`` (``chip_smoke.py`` also
    passes the build of another version of that source, to time the two)."""
    p, n, w = adj_cidx.shape
    t = color_tab.shape[-1]
    if n >= t:
        raise ValueError(f"color_tab: {t} entries cannot hold {n} rows and a pad slot")
    check_tensor(adj_cidx, "adj_cidx", torch.int32, (p, n, w), contiguous=True)
    check_tensor(ext_adj_cidx, "ext_adj_cidx", torch.int32, (p, t, w), contiguous=True)
    tps = check_tensor(color_tab, "color_tab", torch.int32, (p, t))
    check_tensor(base, "base", torch.int32, (p, n), contiguous=True)
    check_tensor(newc, "newc", torch.int32, (p, n), contiguous=True)
    check_tensor(rows, "rows", torch.int32, (rows.shape[0],), contiguous=True)
    fn = lib.d2_assign_list_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(adj_cidx.data_ptr(), ext_adj_cidx.data_ptr(), color_tab.data_ptr(), tps,
             rows.data_ptr(), rows.shape[0], newc.data_ptr(), base.data_ptr(),
             p, n, t, w, int(partial_d2),
             torch.cuda.current_stream(adj_cidx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"d2_assign: kernel launch failed with CUDA error {err}")
    return rows.shape[0] > 0


d2_assign.launches = 0
