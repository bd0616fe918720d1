"""Coloring plans: device state uploaded once, requests run many times.

The paper's motivating workload is *repeated* coloring: scientific codes
recolor the same mesh topology every timestep.  :class:`ColoringPlan` is
the static half — the host-built device-state tables and the exchange
strategy's prepared tables, uploaded to the device once at construction —
and :meth:`ColoringPlan.run` is the dynamic half, which uploads only the
per-request inputs (active mask from ``color_mask``, initial colors plus
the ghost-color table gathered from them, seed).

This is the slim first slice of ``repro/core/plan.py``: no plan cache,
no slot surface and no multi-GPU engine yet (ROADMAP.md, queue 5).
"""
from __future__ import annotations

import copy
from functools import partial

import numpy as np
import torch

from repro_torch.core.backend import LocalBackend, get_backend
from repro_torch.core.distributed import (
    ColoringResult,
    _check_problem,
    _gather_colors,
    _make_loop,
    _recolor_part,
    _round_part,
    build_device_state,
    state_to_torch,
)
from repro_torch.core.exchange import ExchangeStrategy, get_exchange
from repro_torch.core.validate import num_colors
from repro_torch.graph.csr import SENTINEL
from repro_torch.graph.partition import PAD_GID, PartitionedGraph

__all__ = ["ColoringPlan", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``.  A CUDA device without a card raises: the port
    never falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is false); "
            "pass device='cpu' to run on the CPU")
    return dev


class ColoringPlan:
    """Frozen static half of a distributed coloring; see module docstring."""

    def __init__(self, pg: PartitionedGraph, *, problem: str = "d1",
                 recolor_degrees: bool = True,
                 backend: str | LocalBackend = "reference",
                 exchange: str | ExchangeStrategy = "all_gather",
                 max_rounds: int = 64, device=None):
        _check_problem(problem)
        self.device = resolve_device(device)
        self.problem = problem
        self.recolor_degrees = recolor_degrees
        self.max_rounds = max_rounds
        self.n_parts = pg.n_parts
        self.n_local = pg.n_local
        self.n_global = pg.n_global
        self._vertex_gid = pg.vertex_gid
        self._real = pg.vertex_gid != PAD_GID
        self._gids = np.clip(pg.vertex_gid, 0, pg.n_global - 1)
        # Ghost gid gather tables: initial ghost colors are a per-request
        # input derived from colors0.
        self._ghost_real = pg.ghost_gid != SENTINEL
        self._ghost_gids = np.clip(pg.ghost_gid, 0, pg.n_global - 1)
        # Copy the strategy so plans never share prepare()-written state.
        self._strategy = copy.copy(get_exchange(exchange))
        self._backend = get_backend(backend)

        st_np = build_device_state(pg, problem)
        # active0 is the per-request input that color_mask varies.
        self._active0 = st_np.pop("active0")
        st_np.update(self._strategy.prepare(pg, st_np))
        self._st = state_to_torch(st_np, self.device)

        step_kw = dict(problem=problem, recolor_degrees=recolor_degrees,
                       backend=self._backend)
        st = self._st
        self._loop = _make_loop(
            partial(_recolor_part, st, **step_kw),
            partial(_round_part, st, **step_kw),
            partial(self._strategy.stacked, st),
            torch.sum,
            max_rounds=max_rounds,
        )

    def request_inputs(self, color_mask=None, colors0=None, seed=None):
        """Host-side per-request inputs ``(colors0, ghost0, active0, seed)``.

        Stacked ``(P, ...)`` numpy arrays.  ``ghost0`` replicates
        ``colors0`` onto each part's ghost slots, so warm starts see frozen
        cross-partition colors in the very first recolor.
        """
        active0 = self._active0
        if color_mask is not None:
            active0 = active0 & np.asarray(color_mask, bool)[self._gids]
        if colors0 is None:
            c0 = np.zeros((self.n_parts, self.n_local), np.int32)
            g0 = np.zeros(self._ghost_gids.shape, np.int32)
        else:
            colors0 = np.asarray(colors0, np.int32)
            c0 = np.where(self._real, colors0[self._gids], 0)
            g0 = np.where(self._ghost_real, colors0[self._ghost_gids], 0)
        return c0, g0, active0, np.int32(0 if seed is None else seed)

    def run(self, color_mask=None, colors0=None, seed=None) -> ColoringResult:
        """Execute one recoloring request.

        color_mask: optional (n_global,) bool — color only this subset.
        colors0: optional (n_global,) int32 — initial colors (vertices
        outside ``color_mask`` keep theirs, constraining the active set).
        seed: reserved per-request input; the built-in backends are
        deterministic and ignore it.
        """
        c0, g0, active0, _ = self.request_inputs(color_mask, colors0, seed)
        dev = self.device
        colors, rounds, conf, total, nbytes = self._loop(
            torch.from_numpy(c0).to(dev), torch.from_numpy(g0).to(dev),
            torch.from_numpy(active0).to(dev),
            torch.zeros(self._st["ghost_real"].shape, dtype=torch.bool, device=dev),
            self._strategy.init_state(self._st),
        )
        return self._result(colors, rounds, conf, total, nbytes)

    def _result(self, colors, rounds, conf, total, nbytes) -> ColoringResult:
        by_level = nbytes.cpu().numpy()[: rounds + 1]
        by_round = by_level.sum(axis=1)
        gathered = _gather_colors(self, colors.cpu().numpy())
        return ColoringResult(
            colors=gathered,
            rounds=int(rounds),
            converged=bool(int(conf) == 0),
            n_colors=num_colors(gathered),
            total_conflicts=int(total),
            comm_bytes_per_round=int(by_round.mean()) if by_round.size else 0,
            problem=self.problem,
            n_parts=self.n_parts,
            backend=self._backend.name,
            exchange=self._strategy.name,
            comm_bytes_total=int(by_round.sum()),
            comm_bytes_by_round=by_round.astype(np.int64),
            comm_bytes_by_level=by_level.astype(np.int64),
        )

    # _gather_colors only needs .n_global / .vertex_gid.
    @property
    def vertex_gid(self):
        return self._vertex_gid
