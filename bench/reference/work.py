"""The bytes that a coloring request needs, counted from the graph.

The yardstick of ``coloring_roofline_share``: it counts the work of the
algorithm, not of the kernels that happen to run, so a later change of
kernels leaves it unchanged.  For every pass of the reference (the first
coloring, then every round), with ``rows`` the rows it colored or checked:

* the adjacency rows it reads, ``W`` int32 lanes each: ``rows``, and for
  distance 2 also their neighbours (whose rows lead to the second hop);
* the color and the degree (int32 each) of every vertex it reads: ``rows``
  and every vertex within one hop (two for distance 2);
* one int32 color written for every row it colored.

Each byte is counted once a pass, however often a kernel reads it again.
"""
from __future__ import annotations

import torch

from bench.reference.coloring import Pass, Result, Topology

INT32 = 4


def _mark(topo: Topology, rows: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """``rows`` and every real vertex their ``lanes`` hold, as an (n,) mask."""
    seen = torch.zeros(topo.n + 1, dtype=torch.bool, device=topo.device)
    seen[: topo.n] = rows
    idx = torch.nonzero(rows).view(-1)
    for lo in range(0, idx.numel(), 1 << 22):
        seen[lanes[idx[lo:lo + (1 << 22)]].reshape(-1)] = True
    return seen[: topo.n]


def pass_bytes(topo: Topology, ps: Pass) -> int:
    """Bytes one pass needs (see the module docstring)."""
    rows = ps.colored | ps.checked
    adjacency = _mark(topo, rows, topo.one_hop) if topo.problem == "d2" else rows
    read = _mark(topo, rows, topo.lanes)
    return INT32 * (topo.w * int(adjacency.sum()) + 2 * int(read.sum())
                    + int(ps.colored.sum()))


def request_bytes(topo: Topology, result: Result) -> int:
    """Bytes the whole request needs: the sum over its passes."""
    return sum(pass_bytes(topo, ps) for ps in result.passes)
