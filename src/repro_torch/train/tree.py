"""The few tree operations training needs, on the port's trees: nested
dicts of tensors (parameters, optimizer state, gradients).  Leaves come in
``jax.tree``'s order for dicts, keys sorted, so sums over leaves add in
``repro``'s order and checkpoint keys are ``repro``'s."""
from __future__ import annotations

from typing import Any, Callable

SEP = "/"


def flatten(tree: dict) -> dict[str, Any]:
    """``{path: leaf}`` in sorted-key order; a path joins the keys with
    ``/``, as ``repro``'s checkpoint keys do."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update({f"{k}{SEP}{p}": leaf for p, leaf in flatten(v).items()})
        else:
            out[str(k)] = v
    return out


def shard(t):
    """The rank's shard of a DTensor (its local tensor, the same storage);
    a plain tensor as it is.  Elementwise updates in place run on shards,
    with no DTensor dispatch for each operation."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def whole(t):
    """A DTensor's full value on every rank (a collective); a plain tensor
    as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def placed_like(g, p):
    """A DTensor gradient in its parameter's placements (a plain one as is)."""
    from torch.distributed.tensor import DTensor

    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def leaves(tree: dict) -> list:
    return list(flatten(tree).values())


def tree_map(fn: Callable, tree: dict, *rest: dict) -> dict:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def map_with_path(fn: Callable, tree: dict, prefix: str = "") -> dict:
    """``fn(path, leaf)`` over the leaves of ``tree``, paths as ``flatten``'s."""
    return {k: map_with_path(fn, v, f"{prefix}{k}{SEP}") if isinstance(v, dict)
            else fn(f"{prefix}{k}", v) for k, v in tree.items()}
