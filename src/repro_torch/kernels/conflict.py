"""``conflict`` — Algorithm-4 owned-vs-ghost conflict detection.

The CUDA kernel (``csrc/conflict.cu``) replaces the TPU kernel
``repro/kernels/conflict.py::conflict_detect``; :func:`conflict_detect_ref`
is its plain-PyTorch version, the counterpart of
``repro/kernels/ref.py::conflict_detect_ref``.  Both work on the stacked
part axis and return the per-edge ``lose_o (P, N, W)``, which the chained
backend scatters into the ghost lose table, and one count per part.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.conflict import v_loses
from repro_torch.core.local import gather_rows
from repro_torch.kernels import check_tensor, on_cpu
from repro_torch.kernels.build import load

__all__ = ["conflict_detect", "conflict_detect_ref"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
_ARGTYPES = [_P, _P, _I64, _P, _I64, _P, _I64, _P, _I64, _P, _P, _P, _I64,
             _INT, _INT, _INT, _P, _P, _P, _INT, _INT, _INT, _P]


def conflict_detect_ref(adj_cidx, colors, deg, gid, is_boundary,
                        color_tab, deg_tab, gid_tab, n_loc, *,
                        recolor_degrees=True):
    """Plain version of :func:`conflict_detect`."""
    n_tab = color_tab.shape[-1] - 1     # last slot is pad
    idx = adj_cidx.to(torch.int64)
    co, do, go = (gather_rows(t, idx) for t in (color_tab, deg_tab, gid_tab))
    is_ghost = (adj_cidx >= n_loc) & (adj_cidx < n_tab)
    cv, dv, gv = colors[..., None], deg[..., None], gid[..., None]
    vl = v_loses(cv, co, dv, do, gv, go, recolor_degrees=recolor_degrees) & is_ghost
    ol = v_loses(co, cv, do, dv, go, gv, recolor_degrees=recolor_degrees) & is_ghost
    lose_v = vl.any(dim=-1) & is_boundary.to(torch.bool)
    count = (vl | ol).sum(dim=(1, 2)).to(torch.int32)
    return lose_v, ol, count


def conflict_detect(
    adj_cidx: torch.Tensor,      # (P, N, W) int32, contiguous
    colors: torch.Tensor,        # (P, N) int32 local colors
    deg: torch.Tensor,           # (P, N) int32
    gid: torch.Tensor,           # (P, N) int32
    is_boundary: torch.Tensor,   # (P, N) bool
    color_tab: torch.Tensor,     # (P, T) int32
    deg_tab: torch.Tensor,       # (P, T) int32
    gid_tab: torch.Tensor,       # (P, T) int32
    n_loc: int,
    *,
    recolor_degrees: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(lose_v (P, N) bool, lose_o (P, N, W) bool, count (P,) int32)``.

    Every index in ``adj_cidx`` must lie in ``[0, T)``.
    """
    args = (adj_cidx, colors, deg, gid, is_boundary, color_tab, deg_tab, gid_tab)
    if on_cpu(*args):
        return conflict_detect_ref(*args, n_loc, recolor_degrees=recolor_degrees)
    p, n, w = adj_cidx.shape
    t = color_tab.shape[-1]
    check_tensor(adj_cidx, "adj_cidx", torch.int32, (p, n, w), contiguous=True)
    cps = check_tensor(colors, "colors", torch.int32, (p, n))
    dps = check_tensor(deg, "deg", torch.int32, (p, n))
    gps = check_tensor(gid, "gid", torch.int32, (p, n))
    bps = check_tensor(is_boundary, "is_boundary", torch.bool, (p, n))
    tps = check_tensor(color_tab, "color_tab", torch.int32, (p, t))
    for name, tab in (("deg_tab", deg_tab), ("gid_tab", gid_tab)):
        if check_tensor(tab, name, torch.int32, (p, t)) != tps:
            raise ValueError(f"{name}: must share color_tab's part stride")
    dev = adj_cidx.device
    lose_v = torch.empty((p, n), dtype=torch.uint8, device=dev)
    lose_o = torch.empty((p, n, w), dtype=torch.uint8, device=dev)
    count = torch.zeros((p,), dtype=torch.int32, device=dev)
    fn = load("conflict").conflict_detect_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(adj_cidx.data_ptr(), colors.data_ptr(), cps, deg.data_ptr(), dps,
             gid.data_ptr(), gps, is_boundary.data_ptr(), bps,
             color_tab.data_ptr(), deg_tab.data_ptr(), gid_tab.data_ptr(), tps,
             n_loc, t - 1, int(recolor_degrees),
             lose_v.data_ptr(), lose_o.data_ptr(), count.data_ptr(), p, n, w,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conflict_detect: kernel launch failed with CUDA error {err}")
    conflict_detect.launches += 1
    return lose_v.view(torch.bool), lose_o.view(torch.bool), count


conflict_detect.launches = 0
