"""Speculative local coloring — VB_BIT over the stacked part axis.

Plain-PyTorch reference implementation; ``repro_torch.kernels.vb_bit`` is
the CUDA kernel with identical semantics (held equal to its plain version
on the card by ``chip_smoke.py``).

Algorithm (per part, KokkosKernels VB_BIT):
  repeat until no active vertex is uncolored:
    1. every uncolored active vertex builds a uint32 *forbidden mask* over
       its private color window ``[base_v, base_v + 32)`` from neighbor
       colors, takes the lowest clear bit; a full mask bumps the window;
    2. speculative assignment may collide; the Alg-4 loser rule
       (:func:`repro_torch.core.conflict.v_loses`) uncolors the losers.

Every array carries the part axis first: ``adj_cidx (P, N, W)``,
``color_tab (P, T)``, ``active (P, N)``.  Each part iterates to its own
fixed point: a part whose active vertices are all colored stops and keeps
its table, window bases and iteration count while the others go on, so
the result equals coloring each part alone.  The stop test
``any(active & uncolored)`` is read on the host once per iteration.

Masks are int64 tensors holding uint32 values: eager PyTorch has no
unsigned 32-bit shift, compare or popcount on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.conflict import MASK32, v_loses

__all__ = ["local_color_d1", "forbidden_mask", "pick_color", "collision_losers"]

MAX_ITERS_D1 = 512


def gather_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[p, ...] = tab[p, idx[p, ...]]`` for a ``(P, T)`` table."""
    p = tab.shape[0]
    flat = idx.reshape(p, -1).to(torch.int64)
    return torch.gather(tab, 1, flat).reshape(idx.shape)


def forbidden_mask(nbr_colors: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """uint32 forbidden mask (as int64) over ``[base, base+32)`` per row.

    nbr_colors: (..., K) int neighbor colors (0 = uncolored/pad: never
    forbidden).  base: (...,) int window starts.
    """
    rel = nbr_colors.to(torch.int64) - base.to(torch.int64)[..., None]
    in_window = (nbr_colors > 0) & (rel >= 0) & (rel < 32)
    bits = torch.where(in_window, 1 << rel.clamp(0, 31), 0)
    mask = torch.zeros(base.shape, dtype=torch.int64, device=base.device)
    for k in range(bits.shape[-1]):             # OR-reduce over the lanes
        mask |= bits[..., k]
    return mask


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values in ``[0, 2**32)`` (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def pick_color(forbidden: torch.Tensor, base: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Lowest allowed color in the window, and whether one exists.

    Returns ``(color, ok)``; color is valid only where ``ok``, and ``ok``
    is false exactly where the mask is ``0xFFFFFFFF``.  ``t = ~f & (f+1)``
    isolates the lowest zero bit; its index is ``popcount(t - 1)``.
    """
    t = (~forbidden) & (forbidden + 1) & MASK32
    ok = t != 0
    bitpos = _popcount32((t - 1) & MASK32)
    return (base + torch.where(ok, bitpos, 0)).to(torch.int32), ok


def collision_losers(colors, color_tab, adj_cidx, deg_tab, gid_tab, *,
                     recolor_degrees: bool) -> torch.Tensor:
    """Alg-4 speculative-collision test of each owned row over ALL of its
    neighbors (owned, ghost and pad): ``(P, N)`` bool, true where the row
    loses to some neighbor.  ``color_tab`` already holds ``colors``."""
    n_loc = colors.shape[-1]
    idx = adj_cidx.to(torch.int64)      # one index conversion, three gathers
    return v_loses(
        colors[..., None], gather_rows(color_tab, idx),
        deg_tab[:, :n_loc, None], gather_rows(deg_tab, idx),
        gid_tab[:, :n_loc, None], gather_rows(gid_tab, idx),
        recolor_degrees=recolor_degrees,
    ).any(dim=-1)


def _speculate_round(color_tab, base, adj_cidx, active, deg_tab, gid_tab,
                     recolor_degrees):
    """One speculate+resolve round (one-hop). Returns (color_tab, base)."""
    n_loc = active.shape[-1]
    colors_loc = color_tab[:, :n_loc]
    uncolored = active & (colors_loc == 0)

    base_eff = torch.where(uncolored, base, 1)
    mask = forbidden_mask(gather_rows(color_tab, adj_cidx), base_eff)
    cand, ok = pick_color(mask, base_eff)
    new_colors = torch.where(uncolored & ok, cand, colors_loc)
    new_base = torch.where(uncolored & ~ok, base + 32, base)
    color_tab = color_tab.clone()
    color_tab[:, :n_loc] = new_colors

    lose = active & collision_losers(new_colors, color_tab, adj_cidx, deg_tab,
                                     gid_tab, recolor_degrees=recolor_degrees)
    color_tab[:, :n_loc] = torch.where(lose, 0, new_colors)
    return color_tab, new_base


def iterate_parts(step, color_tab, active, *, max_iters: int):
    """Run ``step(color_tab, base) -> (color_tab, base)`` to each part's
    fixed point.

    A part runs while it has an active uncolored row and fewer than
    ``max_iters`` iterations; parts that stopped keep their carries.  All
    running parts share one iteration count, so the cap holds per part.
    """
    n_loc = active.shape[-1]
    base = torch.ones(active.shape, dtype=torch.int32, device=active.device)
    for _ in range(max_iters):
        running = (active & (color_tab[:, :n_loc] == 0)).any(dim=1)
        if not bool(running.any()):             # host sync
            break
        new_tab, new_base = step(color_tab, base)
        color_tab = torch.where(running[:, None], new_tab, color_tab)
        base = torch.where(running[:, None], new_base, base)
    return color_tab


def local_color_d1(
    adj_cidx: torch.Tensor,      # (P, Nv, W) indices into the color table
    color_tab: torch.Tensor,     # (P, Nt) colors; [:Nv] owned, rest ghosts+pad
    active: torch.Tensor,        # (P, Nv) bool — vertices to (re)color
    deg_tab: torch.Tensor,       # (P, Nt) degrees
    gid_tab: torch.Tensor,       # (P, Nt) global ids (pad: unique large)
    *,
    recolor_degrees: bool = True,
    max_iters: int = MAX_ITERS_D1,
) -> torch.Tensor:
    """Distance-1 speculative local coloring. Returns the updated table."""
    def step(tab, base):
        return _speculate_round(tab, base, adj_cidx, active, deg_tab, gid_tab,
                                recolor_degrees)

    return iterate_parts(step, color_tab, active, max_iters=max_iters)
