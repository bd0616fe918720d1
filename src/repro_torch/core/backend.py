"""Pluggable local-compute backends for the distributed coloring runtime.

The per-part compute steps of the speculate-and-iterate loop — speculative
local (re)coloring and cross-partition conflict detection — sit behind a
small :class:`LocalBackend` interface with two implementations:

* ``reference`` — plain PyTorch (``repro_torch.core.local``); the oracle;
* ``cuda``      — the chained hand-written kernels
  (``repro_torch.kernels``): ``vb_bit`` assignment and the ``conflict``
  detection kernel; the counterpart of ``repro``'s ``pallas`` backend.

Both implement the same math, so swapping backends changes neither
colorings nor round counts.  On CPU tensors the ``cuda`` backend's kernel
wrappers take their plain versions, which is how the CPU tests drive its
control flow.

Every method works on the stacked part axis: ``adj_cidx (P, N, W)``,
``color_tab (P, T)`` with ``T = N + G + 1`` (owned vertices, then ghosts,
then one pad slot), rows ``(P, N)``.
"""
from __future__ import annotations

import torch

from repro_torch.core.conflict import v_loses
from repro_torch.core.local import gather_rows, local_color_d1
from repro_torch.core.registry import Registry

__all__ = [
    "LocalBackend",
    "ReferenceBackend",
    "CudaBackend",
    "BACKENDS",
    "get_backend",
    "list_backends",
    "register_backend",
]


class LocalBackend:
    """Interface for per-part compute steps (no exchange)."""

    name: str = "abstract"

    def color_d1(self, adj_cidx, color_tab, active, deg_tab, gid_tab, *,
                 recolor_degrees: bool):
        """Distance-1 speculative coloring of ``active`` rows; returns the
        updated color table."""
        raise NotImplementedError

    def color_d2(self, adj_cidx, two_hop_cidx, ext_adj_cidx, color_tab, active,
                 deg_tab, gid_tab, *, partial_d2: bool, recolor_degrees: bool):
        """Distance-2 / partial-distance-2 speculative coloring."""
        raise NotImplementedError(
            "d2/pd2 coloring is not ported yet (ROADMAP.md, queue 1: "
            "local_color_d2 and d2_forbidden)")

    def detect(self, adj_cidx, colors_loc, color_tab, deg_tab, gid_tab,
               is_boundary, *, recolor_degrees: bool):
        """Alg-4 owned-vs-ghost conflict sweep over one adjacency block.

        Returns ``(lose_v (P, N), lose_o (P, N, W), count (P,))``: per-row
        lose mask (already boundary-masked), per-edge neighbor-side lose
        flags (scattered into the ghost table by the caller), and the
        conflict count of each part.
        """
        raise NotImplementedError

    def round(self, st, colors_loc, ghost_colors, *, problem: str,
              recolor_degrees: bool):
        """One fused inner round: detect conflicts against the freshly
        exchanged ghosts, zero the losers, and speculatively recolor them
        for the next round.

        Returns ``(new_colors (P, N), lose_loc (P, N) bool, lose_ghost
        (P, G) bool, n_conflicts (P,) int32)``.  The default is the
        decomposed ``_detect_part`` → ``_recolor_part`` composition.
        """
        from repro_torch.core.distributed import _detect_part, _recolor_part

        kw = dict(problem=problem, recolor_degrees=recolor_degrees,
                  backend=self)
        lose_l, lose_g, conf = _detect_part(st, colors_loc, ghost_colors, **kw)
        colors = torch.where(lose_l, 0, colors_loc)
        colors = _recolor_part(st, colors, ghost_colors, lose_l, lose_g, **kw)
        return colors, lose_l, lose_g, conf


class ReferenceBackend(LocalBackend):
    """Plain-PyTorch backend (``repro_torch.core.local`` + ``v_loses``)."""

    name = "reference"

    def color_d1(self, adj_cidx, color_tab, active, deg_tab, gid_tab, *,
                 recolor_degrees):
        return local_color_d1(adj_cidx, color_tab, active, deg_tab, gid_tab,
                              recolor_degrees=recolor_degrees)

    def detect(self, adj_cidx, colors_loc, color_tab, deg_tab, gid_tab,
               is_boundary, *, recolor_degrees):
        n_loc = colors_loc.shape[-1]
        n_tab = color_tab.shape[-1] - 1     # last slot is pad
        is_ghost = (adj_cidx >= n_loc) & (adj_cidx < n_tab)
        idx = adj_cidx.to(torch.int64)
        co, do, go = (gather_rows(t, idx) for t in (color_tab, deg_tab, gid_tab))
        cv = colors_loc[..., None]
        dv, gv = deg_tab[:, :n_loc, None], gid_tab[:, :n_loc, None]
        vl = v_loses(cv, co, dv, do, gv, go,
                     recolor_degrees=recolor_degrees) & is_ghost
        ol = v_loses(co, cv, do, dv, go, gv,
                     recolor_degrees=recolor_degrees) & is_ghost
        lose_v = vl.any(dim=-1) & is_boundary
        return lose_v, ol, (vl | ol).sum(dim=(1, 2)).to(torch.int32)


class CudaBackend(LocalBackend):
    """Hand-written CUDA kernel backend (``repro_torch.kernels.ops``)."""

    name = "cuda"

    def color_d1(self, adj_cidx, color_tab, active, deg_tab, gid_tab, *,
                 recolor_degrees):
        from repro_torch.kernels.ops import local_color_d1_cuda

        return local_color_d1_cuda(adj_cidx, color_tab, active, deg_tab,
                                   gid_tab, recolor_degrees=recolor_degrees)

    def detect(self, adj_cidx, colors_loc, color_tab, deg_tab, gid_tab,
               is_boundary, *, recolor_degrees):
        from repro_torch.kernels.ops import conflict_detect

        n_loc = colors_loc.shape[-1]
        return conflict_detect(
            adj_cidx, colors_loc, deg_tab[:, :n_loc], gid_tab[:, :n_loc],
            is_boundary, color_tab, deg_tab, gid_tab, n_loc,
            recolor_degrees=recolor_degrees,
        )


BACKENDS: Registry = Registry(
    "backend",
    {
        "reference": ReferenceBackend,
        "cuda": CudaBackend,
    },
    instance_of=LocalBackend,
    instantiate=True,
    default="reference",
)


def register_backend(name: str, cls: type[LocalBackend]) -> None:
    """Register a third-party :class:`LocalBackend` under ``name``."""
    BACKENDS.register(name, cls)


def list_backends() -> list[str]:
    """Sorted registered backend names (drives the CLI choices)."""
    return BACKENDS.names()


def get_backend(backend: str | LocalBackend | None) -> LocalBackend:
    """Resolve ``backend`` (name, instance, or None → reference)."""
    return BACKENDS.resolve(backend)
