"""The ``(node, local)`` factorization of the part axis.

The port's own copy of ``factor_parts`` from ``repro/launch/mesh.py``.
The device-mesh constructors belong to the multi-GPU engine, which is not
ported yet (ROADMAP.md, queue 1 item 8).
"""
from __future__ import annotations

import math
import os

__all__ = ["factor_parts"]


def factor_parts(n_parts: int, node_size: int | None = None) -> tuple[int, int]:
    """``(n_nodes, node_size)`` factorization of the part count.

    The 2D (node, local) layout the hierarchical exchange assumes: parts
    ``A·node_size .. A·node_size + node_size - 1`` share node ``A``'s
    fast links; one leader per node crosses the slow axis.

    ``node_size=None`` reads ``REPRO_NODE_SIZE`` (0/unset = auto); auto
    picks the largest divisor of ``n_parts`` that is ``<= sqrt(n_parts)``
    (the squarest factorization, e.g. 4 → 2×2, 8 → 4×2, 12 → 4×3 nodes).
    A prime part count degrades to ``(n_parts, 1)`` — every part its own
    leader, so the hierarchy collapses to the flat point-to-point plan.
    """
    if n_parts < 1:
        raise ValueError(f"n_parts must be >= 1, got {n_parts}")
    if node_size is None:
        node_size = int(os.environ.get("REPRO_NODE_SIZE", "0")) or None
    if node_size is None:
        node_size = 1
        for d in range(1, int(math.isqrt(n_parts)) + 1):
            if n_parts % d == 0:
                node_size = d
    if node_size < 1 or n_parts % node_size:
        raise ValueError(
            f"node_size {node_size} must divide the part count {n_parts}")
    return n_parts // node_size, node_size
