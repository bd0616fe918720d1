"""Jones-Plassmann independent-set coloring — the §2.3 comparison point.

The paper (following Bozdağ et al.) *rejects* the JP approach for
distributed memory because it needs many more rounds than speculate-and-
iterate; it is implemented to reproduce that comparison.  Per round, an
uncolored vertex colors itself iff its ``rand(GID)`` beats every uncolored
neighbor's (a local max of the random priority): rounds are conflict-free
by construction, but the independent sets shrink slowly → O(Δ·log n)-ish
rounds vs the speculative loop's 1–8.
"""
from __future__ import annotations

import torch

from repro_torch.core.conflict import gid_hash
from repro_torch.core.distributed import (
    ColoringResult,
    _gather_colors,
    _table,
    state_to_torch,
)
from repro_torch.core.exchange import _gathered_ghosts
from repro_torch.core.local import forbidden_mask, gather_rows, pick_color
from repro_torch.core.plan import cached_device_state, resolve_device
from repro_torch.core.validate import num_colors
from repro_torch.graph.partition import PartitionedGraph

__all__ = ["color_jones_plassmann"]


def _jp_round(st, colors_loc, ghost_colors, base):
    """One JP round over the stacked part axis: local-priority-max
    vertices color."""
    n_loc = colors_loc.shape[-1]
    color_tab = _table(colors_loc, ghost_colors)
    gid_tab = st["gid_tab"]
    adj = st["adj_cidx"].to(torch.int64)
    # Priority = (hash(gid), gid) compared lexicographically; the hash is
    # a uint32 value held in int64, so it compares as repro's uint32 does.
    h = gid_hash(gid_tab)
    uncolored_tab = torch.cat([colors_loc == 0, ghost_colors == 0,
                               torch.zeros_like(colors_loc[:, :1], dtype=torch.bool)],
                              dim=1)

    nbr_h = gather_rows(h, adj)
    nbr_gid = gather_rows(gid_tab, adj)
    nbr_unc = gather_rows(uncolored_tab, adj)
    rival_h_max = torch.where(nbr_unc, nbr_h, 0).amax(dim=-1)
    my_h = h[:, :n_loc]
    at_tie = nbr_unc & (nbr_h == my_h[..., None])
    rival_gid_max = torch.where(at_tie, nbr_gid, -1).amax(dim=-1)
    wins = (
        ((my_h > rival_h_max)
         | ((my_h == rival_h_max) & (gid_tab[:, :n_loc] > rival_gid_max)))
        & (colors_loc == 0) & st["active0"]
    )

    mask = forbidden_mask(gather_rows(color_tab, adj), base)
    cand, ok = pick_color(mask, base)
    new_colors = torch.where(wins & ok, cand, colors_loc)
    new_base = torch.where(wins & ~ok, base + 32, base)
    return new_colors, new_base


def color_jones_plassmann(pg: PartitionedGraph, *, max_rounds: int = 4096,
                          device=None) -> ColoringResult:
    """Distributed JP on the ``simulate`` engine (every part stacked on
    one device); ghosts come from the ``all_gather`` of the send buffers.

    device: ``None`` means ``"cuda"``; pass ``"cpu"`` to run on the CPU.
    """
    dev = resolve_device(device)
    st_np = cached_device_state(pg, "d1")   # plan-layer host-state cache
    st = state_to_torch(st_np, dev)

    p, nl = st_np["adj_cidx"].shape[:2]
    colors = torch.zeros((p, nl), dtype=torch.int32, device=dev)
    base = torch.ones((p, nl), dtype=torch.int32, device=dev)
    ghost = _gathered_ghosts(colors, st)
    rounds = 0
    active_total = int(st_np["active0"].sum())
    while rounds < max_rounds:
        colors, base = _jp_round(st, colors, ghost, base)
        ghost = _gathered_ghosts(colors, st)
        rounds += 1
        done = int(((colors > 0) & st["active0"]).sum())
        if done >= active_total:
            break
    gathered = _gather_colors(pg, colors.cpu().numpy())
    return ColoringResult(
        colors=gathered,
        rounds=rounds,
        converged=bool(done >= active_total),
        n_colors=num_colors(gathered),
        total_conflicts=0,          # JP is conflict-free by construction
        comm_bytes_per_round=p * pg.send_width * 4,
        problem="d1-jp",
        n_parts=pg.n_parts,
    )
