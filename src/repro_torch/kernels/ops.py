"""Kernel-backed local coloring, the counterpart of ``repro/kernels/ops.py``.

``local_color_d1_cuda`` is a drop-in replacement for
``repro_torch.core.local.local_color_d1`` built from the ``vb_bit``
kernel: assignment launches repeated to each part's fixed point, each
followed by the Alg-4 speculative-collision test over all neighbors in
plain PyTorch (as the JAX composite runs it outside any kernel).  The
``cuda`` backend (``repro_torch.core.backend.CudaBackend``) routes every
distance-1 recoloring through it.
"""
from __future__ import annotations

import torch

from repro_torch.core.local import MAX_ITERS_D1, collision_losers, iterate_parts
from repro_torch.kernels.conflict import conflict_detect
from repro_torch.kernels.vb_bit import vb_bit_assign

__all__ = ["vb_bit_assign", "conflict_detect", "local_color_d1_cuda"]


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
