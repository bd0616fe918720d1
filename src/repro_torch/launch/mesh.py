"""Meshes: the counterpart of ``repro/launch/mesh.py``.

``make_mesh`` is a ``torch.distributed`` ``DeviceMesh`` over the default
process group (one process per card), with ``repro``'s axis names as its
dimension names.  ``make_production_mesh`` is a :class:`ShapeMesh`: the
names and sizes of ``repro``'s production meshes, ``(16, 16)`` and ``(2,
16, 16)``, with no process behind them, which is all the sharding rules,
the specs and the dry run read (no group here holds 256 or 512 ranks).
``make_two_level_mesh`` is the ``(node, local)`` factorization of the part
axis as a ``DeviceMesh``; ``factor_parts`` is the port's own copy of
``repro``'s.  Importing this module touches no device and no group.
"""
from __future__ import annotations

import dataclasses
import math
import os

__all__ = ["ShapeMesh", "make_mesh", "make_production_mesh", "make_two_level_mesh",
           "dp_axes", "axis_sizes", "axis_names", "leads", "factor_parts"]


@dataclasses.dataclass(frozen=True)
class ShapeMesh:
    """A mesh's axis names and sizes, with no process behind them."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ShapeMesh(axes, shape)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default group,
    whose world size must be the product of ``shape``; ``device`` is
    ``"cuda"`` (one card a rank) unless the caller asks for ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    return init_device_mesh(str(device), tuple(shape), mesh_dim_names=tuple(axes))


def axis_names(mesh) -> tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or a :class:`ShapeMesh`."""
    if isinstance(mesh, ShapeMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a :class:`ShapeMesh`."""
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes present in a mesh ('pod' + 'data')."""
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def leads(mesh) -> bool:
    """Whether this process is the first rank of ``mesh`` (every coordinate
    0), the one that writes checkpoints and logs; True without a mesh."""
    return mesh is None or not any(mesh.get_coordinate())


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


def make_two_level_mesh(n_parts: int, node_size: int | None = None, *, device="cuda"):
    """A ``(node, local)`` ``DeviceMesh`` over the default group of
    ``n_parts`` ranks.  The coloring engine keeps its flat part axis:
    ``hier_delta`` derives the node structure from :func:`factor_parts`,
    so both views agree as long as ranks enumerate node-major."""
    n_nodes, node_size = factor_parts(n_parts, node_size)
    return make_mesh((n_nodes, node_size), ("node", "local"), device=device)
