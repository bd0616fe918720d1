"""Bozdağ-style batched-boundary coloring — the paper's "Zoltan" baseline.

Zoltan's distributed coloring (Bozdağ et al. [3]) colors *interior* vertices
first, then boundary vertices in small batches with an exchange between
batches.  Lower concurrency → fewer conflicts → quality close to serial, at
the cost of more communication rounds.  The paper compares D1/D2 against
this; it is built on the same per-part step functions as the main runtime
(plain PyTorch, the ``reference`` backend) over the stacked part axis.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.core.conflict import gid_hash
from repro_torch.core.distributed import (
    ColoringResult,
    _detect_part,
    _gather_colors,
    _recolor_part,
    state_to_torch,
)
from repro_torch.core.exchange import _gathered_ghosts
from repro_torch.core.plan import cached_device_state, resolve_device
from repro_torch.core.validate import num_colors
from repro_torch.graph.partition import PartitionedGraph

__all__ = ["color_baseline"]


def color_baseline(
    pg: PartitionedGraph,
    *,
    problem: str = "d1",
    n_batches: int = 8,
    recolor_degrees: bool = False,
    max_rounds: int = 96,
    device=None,
) -> ColoringResult:
    """Batched-boundary distributed coloring (Bozdağ et al. / Zoltan).

    ``recolor_degrees=False`` matches Zoltan's first-fit conflict rule
    (random/GID tiebreaks only).  Every part's ghosts come from the
    ``all_gather`` of the send buffers.

    device: ``None`` means ``"cuda"``; pass ``"cpu"`` to run on the CPU.
    """
    dev = resolve_device(device)
    # Routed through the plan layer's host-state cache: repeated baseline
    # runs (and plans) on one topology share the tables.
    st_np = cached_device_state(pg, problem)
    st = state_to_torch(st_np, dev)
    kw = dict(problem=problem, recolor_degrees=recolor_degrees)
    recolor = partial(_recolor_part, st, **kw)
    detect = partial(_detect_part, st, **kw)
    exchange = partial(_gathered_ghosts, st=st)

    p, g = st_np["ghost_part"].shape
    nl = st_np["adj_cidx"].shape[1]
    active0 = st["active0"]
    boundary = st["is_boundary"] & active0
    interior = active0 & ~boundary
    # Deterministic batch assignment by GID hash (uint32 values in int64).
    batch_of = gid_hash(st["gid_tab"][:, :nl]) % n_batches

    colors = torch.zeros((p, nl), dtype=torch.int32, device=dev)
    zeros_g = torch.zeros((p, g), dtype=torch.int32, device=dev)
    no_ghost_active = torch.zeros_like(st["ghost_real"])

    # Phase 1: interior only — provably conflict-free (paper §3, Bozdağ).
    colors = recolor(colors, zeros_g, interior, no_ghost_active)
    ghost = exchange(colors)

    rounds, total = 0, 0
    lose_l = torch.zeros((p, nl), dtype=torch.bool, device=dev)
    # Phase 2: boundary in batches, exchanging between batches.
    for b in range(n_batches):
        active = (boundary & (batch_of == b)) | lose_l
        colors = torch.where(lose_l, 0, colors)
        colors = recolor(colors, ghost, active, no_ghost_active)
        ghost = exchange(colors)
        lose_l, _, conf = detect(colors, ghost)
        total += int(conf.sum())
        rounds += 1
    # Phase 3: iterate remaining conflicts (like D1's loop).
    conf_g = int(lose_l.sum())
    while conf_g > 0 and rounds < max_rounds:
        colors = torch.where(lose_l, 0, colors)
        colors = recolor(colors, ghost, lose_l, no_ghost_active)
        ghost = exchange(colors)
        lose_l, _, conf = detect(colors, ghost)
        conf_g = int(conf.sum())
        total += conf_g
        rounds += 1

    gathered = _gather_colors(pg, colors.cpu().numpy())
    return ColoringResult(
        colors=gathered,
        rounds=rounds,
        converged=bool(conf_g == 0),
        n_colors=num_colors(gathered),
        total_conflicts=total,
        comm_bytes_per_round=p * pg.send_width * 4,
        problem=f"{problem}-baseline",
        n_parts=p,
    )
