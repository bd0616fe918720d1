"""Kernel-backed local coloring, the counterpart of ``repro/kernels/ops.py``.

``local_color_d1_cuda`` and ``local_color_d2_cuda`` are drop-in
replacements for ``repro_torch.core.local.local_color_d1`` and
``local_color_d2`` built from the ``vb_bit`` and ``d2_forbidden`` kernels:
assignment launches repeated to each part's fixed point, each followed by
the Alg-4 speculative-collision test in plain PyTorch (as the JAX
composites run it outside any kernel): over all neighbors for d1; over the
two-hop block, and the one-hop block unless ``partial_d2``, for d2.  The
``cuda`` backend (``repro_torch.core.backend.CudaBackend``) routes every
local recoloring through them.
"""
from __future__ import annotations

import torch

from repro_torch.core.local import (
    MAX_ITERS_D1, MAX_ITERS_D2, collision_losers, iterate_parts,
)
from repro_torch.kernels.conflict import conflict_detect
from repro_torch.kernels.d2_forbidden import d2_assign
from repro_torch.kernels.fused_round import fused_round
from repro_torch.kernels.scatter import pair_scatter
from repro_torch.kernels.vb_bit import vb_bit_assign

__all__ = ["vb_bit_assign", "conflict_detect", "d2_assign", "fused_round",
           "pair_scatter", "local_color_d1_cuda", "local_color_d2_cuda"]


def local_color_d1_cuda(
    adj_cidx, color_tab, active, deg_tab, gid_tab, *,
    recolor_degrees: bool = True, max_iters: int = MAX_ITERS_D1,
):
    """Kernel-backed distance-1 local coloring (same contract as core.local)."""
    n_loc = active.shape[-1]

    def step(tab, base):
        colors, base = vb_bit_assign(adj_cidx, tab[:, :n_loc], base, active, tab)
        tab = tab.clone()
        tab[:, :n_loc] = colors
        lose = collision_losers(colors, tab, adj_cidx, deg_tab, gid_tab,
                                recolor_degrees=recolor_degrees)
        tab[:, :n_loc] = torch.where(active & lose, 0, colors)
        return tab, base

    return iterate_parts(step, color_tab, active, max_iters=max_iters)


def local_color_d2_cuda(
    adj_cidx, two_hop_cidx, ext_adj_cidx, color_tab, active, deg_tab, gid_tab, *,
    partial_d2: bool = False, recolor_degrees: bool = True,
    max_iters: int = MAX_ITERS_D2,
):
    """Kernel-backed distance-2 local coloring (same contract as core.local).

    Assignment runs through the ``d2_forbidden`` net-based kernel over
    ``ext_adj_cidx``; the collision test reads ``two_hop_cidx``.
    """
    n_loc = active.shape[-1]
    kw = dict(recolor_degrees=recolor_degrees)

    def step(tab, base):
        colors, base = d2_assign(adj_cidx, ext_adj_cidx, tab, base, active,
                                 partial_d2=partial_d2)
        tab = tab.clone()
        tab[:, :n_loc] = colors
        lose = collision_losers(colors, tab, two_hop_cidx, deg_tab, gid_tab, **kw)
        if not partial_d2:
            lose |= collision_losers(colors, tab, adj_cidx, deg_tab, gid_tab, **kw)
        tab[:, :n_loc] = torch.where(active & lose, 0, colors)
        return tab, base

    return iterate_parts(step, color_tab, active, max_iters=max_iters)
