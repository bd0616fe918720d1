"""Kernel-backed local coloring, the counterpart of ``repro/kernels/ops.py``.

``local_color_d1_cuda`` and ``local_color_d2_cuda`` are drop-in
replacements for ``repro_torch.core.local.local_color_d1`` and
``local_color_d2`` built from the ``vb_bit``, ``d2_forbidden`` and
``collision`` kernels: each iteration of a part's fixed point is one
assignment launch and one ``collision`` launch, the Alg-4
speculative-collision test (over all neighbors for d1; over the two-hop
block, and the one-hop block unless ``partial_d2``, for d2), which also
commits the iteration into the fixed point's copy of the color table.
The rows to color and the rows to test are lists built on the device
(``kernels/collision.py``).  The ``cuda`` backend
(``repro_torch.core.backend.CudaBackend``) routes every local recoloring
through them.  On CPU tensors the same loop runs through the kernels'
plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.core.local import MAX_ITERS_D1, MAX_ITERS_D2
from repro_torch.kernels.collision import collision, collision_lists
from repro_torch.kernels.conflict import conflict_detect
from repro_torch.kernels.d2_forbidden import d2_assign
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_round import fused_round
from repro_torch.kernels.scatter import pair_scatter
from repro_torch.kernels.vb_bit import vb_bit_assign

__all__ = ["vb_bit_assign", "conflict_detect", "d2_assign", "collision", "flash_attention",
           "fused_round", "pair_scatter", "local_color_d1_cuda", "local_color_d2_cuda"]


def _fixed_point(assign, color_tab, active, lanes_a, lanes_b, deg_tab, gid_tab, *,
                 newc, base, list_todo, recolor_degrees, max_iters):
    """Run ``assign`` + ``collision`` to each part's fixed point, as
    ``core/local.py::iterate_parts`` runs its step: a part runs while it has
    an active uncolored row, a stopped part keeps its table and bases, and
    all running parts share one iteration count up to ``max_iters``.

    ``assign(tab, todo, newc)`` colors the listed rows (``todo``, or every
    row when ``list_todo`` is false) from the iteration-start table ``tab``
    and returns the rows' new colors.  ``collision`` commits each iteration
    into ``tab``, one copy of ``color_tab`` made here, so the caller's
    table is left as it was.  The one host sync per iteration is the stop
    test, which reads the count of rows left to color.
    """
    color_tab = color_tab.clone()
    p, r = active.shape
    dev = active.device
    i32 = dict(dtype=torch.int32, device=dev)
    counts = torch.zeros((3, p + 2), **i32)     # three rows used in turn
    rows = torch.empty((p * r,), **i32)
    todo = torch.empty((2, p * r), **i32) if list_todo else None
    collision_lists(active, color_tab, rows, None if todo is None else todo[0], counts[0],
                    newc=newc, base=base)
    n_todo, n_rows = counts[0, p:].tolist()     # host sync: the stop test
    rows = rows[:n_rows]
    lose = torch.empty((n_rows,), dtype=torch.bool, device=dev)
    for it in range(max_iters):
        if n_todo == 0:
            break
        newc = assign(color_tab, None if todo is None else todo[it % 2, :n_todo], newc)
        collision(lanes_a, lanes_b, newc, color_tab, deg_tab, gid_tab, rows,
                  counts[it % 3], counts[(it + 1) % 3], counts[(it + 2) % 3],
                  None if todo is None else todo[(it + 1) % 2], lose,
                  recolor_degrees=recolor_degrees)
        if it + 1 < max_iters:
            n_todo = int(counts[(it + 1) % 3, p])   # host sync: the stop test
    return color_tab


def local_color_d1_cuda(
    adj_cidx, color_tab, active, deg_tab, gid_tab, *,
    recolor_degrees: bool = True, max_iters: int = MAX_ITERS_D1,
):
    """Kernel-backed distance-1 local coloring (the contract of core.local).

    Each iteration is one ``vb_bit`` launch over every row (its rows not to
    color keep their color and base) and one ``collision`` launch over the
    active rows.  ``active`` may cover the whole table (``d1_2gl``).
    """
    n = active.shape[-1]
    base = torch.ones(active.shape, dtype=torch.int32, device=active.device)

    def assign(tab, todo, newc):
        nonlocal base
        newc, base = vb_bit_assign(adj_cidx, tab[:, :n], base, active, tab)
        return newc

    return _fixed_point(assign, color_tab, active, adj_cidx, None, deg_tab, gid_tab,
                        newc=None, base=None, list_todo=False,
                        recolor_degrees=recolor_degrees, max_iters=max_iters)


def local_color_d2_cuda(
    adj_cidx, two_hop_cidx, ext_adj_cidx, color_tab, active, deg_tab, gid_tab, *,
    partial_d2: bool = False, recolor_degrees: bool = True,
    max_iters: int = MAX_ITERS_D2,
):
    """Kernel-backed distance-2 local coloring (the contract of core.local).

    Each iteration is one ``d2_assign`` launch over the rows to color,
    reaching the two-hop colors through ``ext_adj_cidx``, and one
    ``collision`` launch over the active rows, testing ``two_hop_cidx``
    and, unless ``partial_d2``, ``adj_cidx``.
    """
    p, n = active.shape
    i32 = dict(dtype=torch.int32, device=active.device)
    newc = torch.empty((p, n), **i32)
    base = torch.empty((p, n), **i32)

    def assign(tab, todo, newc):
        return d2_assign(adj_cidx, ext_adj_cidx, tab, base, newc, todo,
                         partial_d2=partial_d2)[0]

    return _fixed_point(assign, color_tab, active, two_hop_cidx,
                        None if partial_d2 else adj_cidx, deg_tab, gid_tab,
                        newc=newc, base=base, list_todo=True,
                        recolor_degrees=recolor_degrees, max_iters=max_iters)
