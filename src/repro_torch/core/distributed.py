"""Distributed speculate-and-iterate coloring (paper Algorithm 2).

One loop (:func:`_make_loop`) runs the speculate→exchange→round
structure over the stacked part axis on one device (the ``simulate``
engine), parameterized by a pluggable compute backend
(``repro_torch.core.backend``: ``reference`` or ``cuda``) and an exchange
strategy (``repro_torch.core.exchange``: ``all_gather``).  Per-round
payload bytes are measured and reported in
``ColoringResult.comm_bytes_by_round``.

This slice ports the distance-1 problem; ``d1_2gl``, ``d2`` and ``pd2``
raise until their slices land (ROADMAP.md).  :func:`color_distributed`
routes through ``repro_torch.core.plan.ColoringPlan``, which uploads the
device state once; this module keeps the device-state construction, the
per-part step functions and the loop.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.backend import LocalBackend, ReferenceBackend
from repro_torch.core.exchange import ExchangeStrategy, level_split
from repro_torch.graph.csr import SENTINEL, Graph
from repro_torch.graph.partition import PAD_GID, PartitionedGraph, partition_graph

__all__ = [
    "ColoringResult",
    "color_distributed",
    "color_single_device",
    "build_device_state",
    "state_to_torch",
]

PROBLEMS = ("d1", "d1_2gl", "d2", "pd2")
PORTED_PROBLEMS = ("d1",)

_REFERENCE = ReferenceBackend()


@dataclasses.dataclass
class ColoringResult:
    colors: np.ndarray          # (n_global,) gathered global coloring
    rounds: int                 # communication rounds after initial coloring
    converged: bool
    n_colors: int
    total_conflicts: int        # sum over rounds of detected conflicts
    comm_bytes_per_round: int   # mean measured payload per device per round
    problem: str
    n_parts: int
    backend: str = "reference"
    exchange: str = "all_gather"
    comm_bytes_total: int = 0   # sum of per-round measured payloads
    # (rounds+1,) measured payload per device for each exchange, starting
    # with the post-initial-coloring one.
    comm_bytes_by_round: np.ndarray | None = None
    # (rounds+1, 2) [intra-node, inter-node] split of the same payloads.
    # Flat strategies book every byte as inter-node.
    comm_bytes_by_level: np.ndarray | None = None

    @property
    def comm_bytes_intra(self) -> int:
        """Total measured intra-node payload (0 when the split is absent)."""
        lv = self.comm_bytes_by_level
        return int(lv[:, 0].sum()) if lv is not None else 0

    @property
    def comm_bytes_inter(self) -> int:
        """Total measured inter-node payload (= total when split absent)."""
        lv = self.comm_bytes_by_level
        if lv is None:
            return int(self.comm_bytes_total)
        return int(lv[:, 1].sum())


# ---------------------------------------------------------------------------
# Device state construction (host-side, static per graph+partition).
# ---------------------------------------------------------------------------

def build_device_state(pg: PartitionedGraph, problem: str) -> dict[str, np.ndarray]:
    """Stacked (P, ...) arrays consumed by the loop."""
    if problem not in PROBLEMS:
        raise ValueError(f"problem must be one of {PROBLEMS}")
    needs_l2 = problem in ("d1_2gl", "d2", "pd2")
    if needs_l2 and not pg.has_second_layer:
        raise ValueError(f"{problem} requires partition_graph(..., second_layer=True)")
    P, nl, G, W = pg.n_parts, pg.n_local, pg.n_ghost, pg.ell_width
    pad_cidx = nl + G

    gid_tab = np.concatenate(
        [pg.vertex_gid, pg.ghost_gid, np.full((P, 1), PAD_GID, np.int32)], axis=1
    )
    deg_tab = np.concatenate([pg.deg, pg.ghost_deg, np.zeros((P, 1), np.int32)], axis=1)

    state = {
        "adj_cidx": pg.adj_cidx.astype(np.int32),
        "deg_tab": deg_tab.astype(np.int32),
        "gid_tab": gid_tab.astype(np.int32),
        "send_idx": pg.send_idx.astype(np.int32),
        "send_mask": pg.send_mask,
        "ghost_part": pg.ghost_part.astype(np.int32),
        "ghost_slot": pg.ghost_slot.astype(np.int32),
        "ghost_real": (pg.ghost_gid != SENTINEL),
        "active0": (pg.vertex_gid != PAD_GID),
        "is_boundary": pg.is_boundary,
    }
    if needs_l2:
        # Extended adjacency: rows for locals, then ghosts, then a pad row.
        ext = np.concatenate(
            [pg.adj_cidx, pg.ghost_adj_cidx, np.full((P, 1, W), pad_cidx, np.int32)],
            axis=1,
        ).astype(np.int32)
        state["ext_adj_cidx"] = ext
        if problem in ("d2", "pd2"):
            th = ext[np.arange(P)[:, None, None], pg.adj_cidx].reshape(P, nl, W * W)
            state["two_hop_cidx"] = th
            # Distance-2 boundary (paper Fig. 1): a vertex whose one- OR
            # two-hop neighborhood crosses the partition.
            is_ghost = lambda ix: (ix >= nl) & (ix < pad_cidx)  # noqa: E731
            state["is_boundary"] = (
                is_ghost(pg.adj_cidx).any(axis=2)
                | is_ghost(th).any(axis=2)
            )
    return state


def state_to_torch(st_np: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """The numpy device state as tensors on ``device``, values and dtypes
    unchanged (int32 stays int32, bool stays bool)."""
    return {k: torch.tensor(v, device=device) for k, v in st_np.items()}


# ---------------------------------------------------------------------------
# Per-part step functions over the stacked part axis (no exchange).
# ---------------------------------------------------------------------------

def _check_problem(problem: str) -> None:
    if problem not in PORTED_PROBLEMS:
        raise NotImplementedError(
            f"problem {problem!r} is not ported yet (ported: {PORTED_PROBLEMS}; "
            "see ROADMAP.md, queue 1)")


def _table(colors_loc, ghost_colors):
    """``(P, N + G + 1)`` color table: owned, ghosts, one zero pad slot."""
    zero = colors_loc.new_zeros((colors_loc.shape[0], 1))
    return torch.cat([colors_loc, ghost_colors, zero], dim=1)


def _recolor_part(st, colors_loc, ghost_colors, active_loc, active_ghost, *,
                  problem: str, recolor_degrees: bool,
                  backend: LocalBackend | None = None):
    """Recolor active vertices of every part; returns new local colors."""
    _check_problem(problem)
    backend = backend or _REFERENCE
    n_loc = colors_loc.shape[-1]
    color_tab = backend.color_d1(
        st["adj_cidx"], _table(colors_loc, ghost_colors), active_loc,
        st["deg_tab"], st["gid_tab"], recolor_degrees=recolor_degrees,
    )
    return color_tab[:, :n_loc]


def _detect_part(st, colors_loc, ghost_colors, *, problem: str,
                 recolor_degrees: bool, backend: LocalBackend | None = None):
    """Cross-partition conflict detection (Alg. 3).

    Returns (lose_loc (P, N), lose_ghost (P, G), n_conflicts (P,)).  Only
    owned-vs-ghost pairs are conflicts: local pairs are resolved by the
    local coloring.  Both endpoints' owners reach the same verdict because
    the loser rule is a pure function of replicated per-vertex data.
    """
    _check_problem(problem)
    backend = backend or _REFERENCE
    p, n_loc = colors_loc.shape
    n_ghost = ghost_colors.shape[-1]
    color_tab = _table(colors_loc, ghost_colors)
    adj = st["adj_cidx"]
    lose_v, lose_o, n_conf = backend.detect(
        adj, colors_loc, color_tab, st["deg_tab"], st["gid_tab"],
        st["is_boundary"], recolor_degrees=recolor_degrees,
    )
    # Neighbor-side losses land in the part's lose table: True is written
    # at adj[lose_o], every other lane writes to one spare slot past the
    # end.  Every writer writes True, so the result does not depend on
    # order, and no host sync is needed to size a selection.
    n_tab = color_tab.shape[-1]
    part_off = torch.arange(p, device=adj.device, dtype=torch.int64)[:, None, None] * n_tab
    hit = torch.where(lose_o, adj.to(torch.int64) + part_off, p * n_tab)
    lose_tab = torch.zeros(p * n_tab + 1, dtype=torch.bool, device=adj.device)
    lose_tab.index_fill_(0, hit.view(-1), True)
    lose_tab = lose_tab[:-1].view(p, n_tab)
    return lose_v, lose_tab[:, n_loc:n_loc + n_ghost], n_conf


def _round_part(st, colors_loc, ghost_colors, *, problem: str,
                recolor_degrees: bool, backend: LocalBackend | None = None):
    """One fused inner round: detect → zero losers → speculative recolor
    for the next round (``LocalBackend.round``)."""
    backend = backend or _REFERENCE
    return backend.round(st, colors_loc, ghost_colors, problem=problem,
                         recolor_degrees=recolor_degrees)


# ---------------------------------------------------------------------------
# The round loop.
# ---------------------------------------------------------------------------

def _make_loop(recolor, round_fn, exchange, all_sum, *, max_rounds: int):
    """Build the speculate→exchange→round loop.

      recolor(colors, ghost, active_local, active_ghost) -> colors
      round_fn(colors, ghost) -> (colors, lose_local, lose_ghost, n_confl)
      exchange(colors, ex_state) -> (ghost, payload_bytes, ex_state)
      all_sum(x) -> global scalar (sum over the part axis)

    ``round_fn`` fuses conflict detection with the *next* round's
    speculative recoloring: detect round k and recolor round k+1 read the
    same (colors, ghost) tables.  At convergence the trailing recolor has
    an all-false active mask and is the identity.  The loop's test reads
    the summed conflict count on the host once per round.
    """

    def loop(colors0, ghost0, active0, no_ghost_active, ex_state0):
        colors = recolor(colors0, ghost0, active0, no_ghost_active)
        ghost, nbytes, ex_state = exchange(colors, ex_state0)
        colors, _, _, conf = round_fn(colors, ghost)
        conf = all_sum(conf)
        # Byte history carries the [intra-node, inter-node] split per
        # round (flat strategies are booked as inter; see level_split).
        bytes_hist = torch.zeros((max_rounds + 1, 2), dtype=torch.int32,
                                 device=colors.device)
        bytes_hist[0] = level_split(nbytes)
        rounds, total = 0, conf
        while int(conf) > 0 and rounds < max_rounds:        # host sync
            ghost, nbytes, ex_state = exchange(colors, ex_state)
            colors, _, _, conf = round_fn(colors, ghost)
            conf = all_sum(conf)
            rounds += 1
            total = total + conf
            bytes_hist[rounds] = level_split(nbytes)
        return colors, rounds, conf, total, bytes_hist

    return loop


# ---------------------------------------------------------------------------
# Public entry points.
# ---------------------------------------------------------------------------

def _gather_colors(pg, stacked_colors: np.ndarray) -> np.ndarray:
    out = np.zeros(pg.n_global, dtype=np.int32)
    real = pg.vertex_gid != PAD_GID
    out[pg.vertex_gid[real]] = stacked_colors[real]
    return out


def color_distributed(
    pg: PartitionedGraph,
    *,
    problem: str = "d1",
    recolor_degrees: bool = True,
    backend: str | LocalBackend = "reference",
    exchange: str | ExchangeStrategy = "all_gather",
    max_rounds: int = 64,
    engine: str = "simulate",
    color_mask: np.ndarray | None = None,
    device=None,
) -> ColoringResult:
    """Color a partitioned graph with the paper's distributed algorithm.

    Routed through :class:`repro_torch.core.plan.ColoringPlan`: the device
    state is uploaded once, then one request runs.

    backend: ``"reference"`` (plain PyTorch) or ``"cuda"`` (the
    hand-written kernels; their plain versions on CPU tensors).  Both
    produce identical colorings and round counts.

    engine: only ``"simulate"`` (every part stacked on one device).

    color_mask: optional (n_global,) bool — restrict coloring to a vertex
    subset.

    device: ``None`` means ``"cuda"``; pass ``"cpu"`` to run on the CPU.
    Without a card, the default raises instead of falling back.
    """
    from repro_torch.core.plan import ColoringPlan

    if engine != "simulate":
        raise NotImplementedError(
            f"engine {engine!r} is not ported yet (ROADMAP.md, queue 8)")
    plan = ColoringPlan(pg, problem=problem, recolor_degrees=recolor_degrees,
                        backend=backend, exchange=exchange,
                        max_rounds=max_rounds, device=device)
    return plan.run(color_mask=color_mask)


def color_single_device(
    graph: Graph, *, problem: str = "d1", recolor_degrees: bool = True,
    backend: str | LocalBackend = "reference", device=None,
) -> ColoringResult:
    """Single-device speculate&iterate (the paper's 1-GPU baseline)."""
    pg = partition_graph(graph, 1, second_layer=problem != "d1")
    return color_distributed(
        pg, problem=problem, recolor_degrees=recolor_degrees,
        backend=backend, engine="simulate", device=device,
    )
