"""Coloring-quality metrics: color histograms, balance/skew, trajectories.

The paper evaluates every approach on *both* axes — runtime and colors
used (Fig. 2/5/6).  This module makes the quality axis first-class:

* device-side metrics (torch, on the colors' device) —
  :func:`color_histogram_device`, :func:`part_class_sizes`; the reduction
  subsystem's :class:`~repro_torch.core.reduce.ReductionPlan` ranks
  classes from the first;
* host-side report — :func:`quality_report` builds a
  :class:`QualityReport` from a gathered coloring, using the *same*
  histogram oracle as the validators
  (:func:`repro_torch.core.validate.color_histogram`), so device metrics
  and host oracles cannot drift (pinned by tests);
* trajectories — :func:`trajectory` summarizes a colors-by-pass (or
  colors-by-round) sequence.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.validate import color_histogram, num_colors

__all__ = [
    "QualityReport",
    "balance_metrics",
    "color_histogram_device",
    "part_class_sizes",
    "quality_report",
    "trajectory",
]


# ---------------------------------------------------------------------------
# Device-side metrics (torch, on the colors' device; no host sync).
# ---------------------------------------------------------------------------

def color_histogram_device(colors: torch.Tensor, cap: int) -> torch.Tensor:
    """Device color-class sizes over a capacity ``cap``.

    Returns ``(cap,)`` int32 on ``colors``' device with ``h[c]`` =
    vertices of color ``c`` for ``c`` in ``[1, cap)`` and ``h[0] = 0``
    (uncolored vertices are not a class).  Colors ``>= cap`` aggregate
    into the top bucket so the vertex count is conserved; pick ``cap``
    above the expected color count (the reduction plan rounds it up to a
    power of two).
    """
    colors = colors.reshape(-1)
    hist = torch.zeros(cap, dtype=torch.int32, device=colors.device)
    hist.scatter_add_(0, colors.clamp(0, cap - 1).to(torch.int64),
                      (colors > 0).to(torch.int32))
    hist[0] = 0
    return hist


def part_class_sizes(stacked_colors: torch.Tensor, cap: int) -> torch.Tensor:
    """Per-part color-class sizes: ``(P, n_local) -> (P, cap)`` int32.

    Row ``p`` is the device histogram of part ``p``'s owned colors —
    the per-part view of how balanced each color class is across the
    parts (pad slots never carry colors ``> 0``, so they drop out).
    """
    p = stacked_colors.shape[0]
    rows = torch.arange(p, device=stacked_colors.device, dtype=torch.int64)[:, None]
    idx = rows * cap + stacked_colors.clamp(0, cap - 1).to(torch.int64)
    hist = torch.zeros(p * cap, dtype=torch.int32, device=stacked_colors.device)
    hist.scatter_add_(0, idx.reshape(-1), (stacked_colors > 0).to(torch.int32).reshape(-1))
    hist = hist.view(p, cap)
    hist[:, 0] = 0
    return hist


def balance_metrics(hist: np.ndarray) -> tuple[int, int, float, float, float]:
    """``(max, min, mean, balance, skew)`` over non-empty classes.

    ``balance`` = max/mean (1.0 = perfectly balanced classes), ``skew`` =
    max/min.  ``hist`` is a class-size array whose index 0 (uncolored) is
    ignored; empty colorings report zeros.
    """
    sizes = np.asarray(hist)[1:]
    sizes = sizes[sizes > 0]
    if sizes.size == 0:
        return 0, 0, 0.0, 0.0, 0.0
    mx, mn, mean = int(sizes.max()), int(sizes.min()), float(sizes.mean())
    return mx, mn, mean, mx / mean, mx / mn


# ---------------------------------------------------------------------------
# Host-side report.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QualityReport:
    """One coloring's quality axes (paper Fig. 2/5/6 + balance)."""

    n_colors: int
    n_colored: int              # vertices with a color
    n_uncolored: int            # vertices without one (masked runs)
    histogram: np.ndarray       # (max_color+1,) sizes; index 0 = uncolored
    max_class_size: int
    min_class_size: int
    mean_class_size: float
    balance: float              # max/mean over classes; 1.0 = balanced
    skew: float                 # max/min over classes
    part_class_sizes: np.ndarray | None = None   # (P, C+1) when stacked given

    def row(self) -> str:
        """Compact ``k=v`` summary for benchmark ``derived`` columns."""
        return (f"colors={self.n_colors};max_class={self.max_class_size};"
                f"balance={self.balance:.2f};skew={self.skew:.2f}")


def quality_report(colors: np.ndarray, *,
                   stacked_colors=None) -> QualityReport:
    """Build a :class:`QualityReport` from a gathered global coloring.

    ``stacked_colors``: optional ``(P, n_local)`` per-part colors (a
    plan's pre-gather output), numpy or a tensor on any device — adds the
    per-part class-size table, computed where the colors are.
    """
    colors = np.asarray(colors)
    hist = color_histogram(colors)
    mx, mn, mean, balance, skew = balance_metrics(hist)
    parts = None
    if stacked_colors is not None:
        parts = part_class_sizes(torch.as_tensor(stacked_colors),
                                 int(hist.shape[0])).cpu().numpy()
    n_colored = int(hist[1:].sum())
    return QualityReport(
        n_colors=num_colors(colors),
        n_colored=n_colored,
        n_uncolored=int(colors.size - n_colored),
        histogram=hist,
        max_class_size=mx,
        min_class_size=mn,
        mean_class_size=mean,
        balance=balance,
        skew=skew,
        part_class_sizes=parts,
    )


def trajectory(counts, comm_bytes=None) -> str:
    """Render a colors-by-pass (or -round) sequence.

    ``trajectory([12, 10, 9]) == "12>10>9"``; with ``comm_bytes`` the
    per-step payloads are appended as ``;comm=a+b`` so the paper's
    communication-vs-quality tradeoff is one row.
    """
    s = ">".join(str(int(c)) for c in counts)
    if comm_bytes is not None:
        s += ";comm=" + "+".join(str(int(b)) for b in comm_bytes)
    return s
