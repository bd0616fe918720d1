"""``fused_round`` — one whole inner round of the coloring loop in one launch.

The CUDA kernel (``csrc/fused_round.cu``) replaces the TPU kernel
``repro/kernels/fused_round.py::fused_round``: the optional ``(slot,
color)`` pairs scattered into the ghost colors, Alg-4 owned-vs-ghost
detection over the one-hop and/or two-hop blocks, the losers zeroed, and
their recolor fixed point, for every part of the stacked axis in one
cooperative launch.  :func:`fused_round_ref` is the plain version, the
counterpart of ``repro/kernels/ref.py::fused_round_ref``:
``pair_scatter_ref`` into the ghosts, then the decomposed ``_detect_part``
→ zero losers → ``_recolor_part`` composition on the ``reference``
backend.  The ``cuda_fused`` backend
(``repro_torch.core.backend.CudaFusedBackend``) runs every d1, d2 and pd2
round through :func:`fused_round`; like ``repro``'s ``pallas_fused``, it
passes no pairs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.distributed import _detect_part, _recolor_part
from repro_torch.core.local import MAX_ITERS_D1, MAX_ITERS_D2
from repro_torch.kernels import check_tensor, on_cpu
from repro_torch.kernels.build import load
from repro_torch.kernels.scatter import pair_scatter_ref

__all__ = ["fused_round", "fused_round_ref", "launch_kernel"]

# The kernel's problem codes, as csrc/fused_round.cu numbers them.
_PROBLEM_CODES = {"d1": 0, "d2": 1, "pd2": 2}

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
_ARGTYPES = ([_P, _P, _P, _I64, _P, _I64, _P, _P, _I64, _P, _I64, _P, _I64, _P, _I64]
             + [_P] * 8 + [_INT] * 9 + [_P])


def _check_problem(problem: str, two_hop_cidx) -> None:
    if problem not in _PROBLEM_CODES:
        raise ValueError(f"fused_round does not support problem={problem!r} "
                         f"(supported: {sorted(_PROBLEM_CODES)})")
    if problem != "d1" and two_hop_cidx is None:
        raise ValueError(f"problem={problem!r} requires two_hop_cidx")


def _check_pairs(pair_slots, pair_colors) -> None:
    if (pair_slots is None) != (pair_colors is None):
        raise ValueError("pair_slots and pair_colors come together")


def fused_round_ref(adj_cidx, colors, ghost, deg_tab, gid_tab, is_boundary,
                    two_hop_cidx=None, pair_slots=None, pair_colors=None, *,
                    problem="d1", recolor_degrees=True):
    """Plain version of :func:`fused_round`."""
    _check_problem(problem, two_hop_cidx)
    _check_pairs(pair_slots, pair_colors)
    if pair_slots is not None:
        ghost = pair_scatter_ref(ghost, pair_slots, pair_colors)
    st = {"adj_cidx": adj_cidx, "deg_tab": deg_tab, "gid_tab": gid_tab,
          "is_boundary": is_boundary.to(torch.bool),
          # The reference backend's d2 recolor never reads the extended
          # adjacency; the kernel-backed one would.
          "two_hop_cidx": two_hop_cidx, "ext_adj_cidx": None}
    kw = dict(problem=problem, recolor_degrees=recolor_degrees)
    lose_l, lose_g, conf = _detect_part(st, colors, ghost, **kw)
    new_colors = _recolor_part(st, torch.where(lose_l, 0, colors), ghost,
                               lose_l, lose_g, **kw)
    return new_colors, lose_l, lose_g, conf


def fused_round(
    adj_cidx: torch.Tensor,       # (P, N, W) int32, contiguous
    colors: torch.Tensor,         # (P, N) int32 current local colors
    ghost: torch.Tensor,          # (P, G) int32 ghost colors (post-exchange)
    deg_tab: torch.Tensor,        # (P, N+G+1) int32 degrees (pad slot last)
    gid_tab: torch.Tensor,        # (P, N+G+1) int32 global ids
    is_boundary: torch.Tensor,    # (P, N) bool
    two_hop_cidx: torch.Tensor | None = None,   # (P, N, H2) int32, d2/pd2
    pair_slots: torch.Tensor | None = None,     # (P, C) int32 ghost positions
    pair_colors: torch.Tensor | None = None,    # (P, C) int32 their colors
    *,
    problem: str = "d1",
    recolor_degrees: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One round: [pairs into the ghosts →] detect → zero losers →
    speculative recolor to each part's fixed point (at most 512 iterations
    for d1, 1024 for d2 and pd2).

    With pairs, ``ghost[p, pair_slots[p, j]] = pair_colors[p, j]`` is
    applied first; a slot outside ``[0, G)`` is padding and is dropped,
    and the real slots of one part must be unique.

    Returns ``(new_colors (P, N) int32, lose_v (P, N) bool, lose_ghost
    (P, G) bool, n_conflicts (P,) int32)``, exactly :func:`fused_round_ref`.
    Every index in ``adj_cidx`` and ``two_hop_cidx`` must lie in
    ``[0, N+G+1)``.
    """
    _check_problem(problem, two_hop_cidx)
    _check_pairs(pair_slots, pair_colors)
    th = two_hop_cidx if problem != "d1" else None
    args = [adj_cidx, colors, ghost, deg_tab, gid_tab, is_boundary]
    optional = [x for x in (th, pair_slots, pair_colors) if x is not None]
    if on_cpu(*args, *optional):
        return fused_round_ref(*args, th, pair_slots, pair_colors, problem=problem,
                               recolor_degrees=recolor_degrees)
    out = launch_kernel(load("fused_round"), *args, th, pair_slots, pair_colors,
                        problem=problem, recolor_degrees=recolor_degrees,
                        max_iters=MAX_ITERS_D1 if problem == "d1" else MAX_ITERS_D2)
    fused_round.launches += 1
    return out


def launch_kernel(lib, adj_cidx, colors, ghost, deg_tab, gid_tab, is_boundary, two_hop_cidx,
                  pair_slots, pair_colors, *, problem, recolor_degrees, max_iters):
    """One launch of ``lib``'s ``fused_round_launch`` on CUDA tensors, with
    at most ``max_iters`` fixed-point iterations (0: detection only), as
    :func:`fused_round` makes it; counts no launch.  ``lib`` is the loaded
    library of ``csrc/fused_round.cu`` (``chip_smoke.py`` also passes the
    build of another version of that source, to time the two)."""
    p, n, w = adj_cidx.shape
    g = ghost.shape[-1]
    t = n + g + 1
    check_tensor(adj_cidx, "adj_cidx", torch.int32, (p, n, w), contiguous=True)
    th = two_hop_cidx
    h2 = 0
    if th is not None:
        h2 = th.shape[-1]
        check_tensor(th, "two_hop_cidx", torch.int32, (p, n, h2), contiguous=True)
    cps = check_tensor(colors, "colors", torch.int32, (p, n))
    gps = check_tensor(ghost, "ghost", torch.int32, (p, g))
    bps = check_tensor(is_boundary, "is_boundary", torch.bool, (p, n))
    tps = check_tensor(deg_tab, "deg_tab", torch.int32, (p, t))
    if check_tensor(gid_tab, "gid_tab", torch.int32, (p, t)) != tps:
        raise ValueError("gid_tab: must share deg_tab's part stride")
    c, sps, pcps = 0, 0, 0
    if pair_slots is not None:
        c = pair_slots.shape[-1]
        sps = check_tensor(pair_slots, "pair_slots", torch.int32, (p, c))
        pcps = check_tensor(pair_colors, "pair_colors", torch.int32, (p, c))
    dev = adj_cidx.device
    i32 = dict(dtype=torch.int32, device=dev)
    tab = torch.empty((p, t), **i32)
    newc = torch.empty((p, n), **i32)
    base = torch.empty((p, n), **i32)
    remaining = torch.zeros((3 * p + 1,), **i32)
    out_colors = torch.empty((p, n), **i32)
    lose_v = torch.empty((p, n), dtype=torch.uint8, device=dev)
    lose_g = torch.zeros((p, g), dtype=torch.uint8, device=dev)
    count = torch.zeros((p,), **i32)
    fn = lib.fused_round_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(adj_cidx.data_ptr(), th.data_ptr() if th is not None else None,
             colors.data_ptr(), cps, ghost.data_ptr(), gps,
             deg_tab.data_ptr(), gid_tab.data_ptr(), tps,
             is_boundary.data_ptr(), bps,
             pair_slots.data_ptr() if pair_slots is not None else None, sps,
             pair_colors.data_ptr() if pair_colors is not None else None, pcps,
             tab.data_ptr(), newc.data_ptr(), base.data_ptr(), remaining.data_ptr(),
             out_colors.data_ptr(), lose_v.data_ptr(), lose_g.data_ptr(),
             count.data_ptr(), p, n, g, w, h2, c, _PROBLEM_CODES[problem],
             int(recolor_degrees), max_iters,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_round: kernel launch failed with CUDA error {err}")
    return out_colors, lose_v.view(torch.bool), lose_g.view(torch.bool), count


fused_round.launches = 0
