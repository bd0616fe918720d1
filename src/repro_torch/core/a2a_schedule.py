"""Coloring-scheduled all-to-all phases (route plans of the sparse exchanges).

Under a one-send/one-receive-per-phase port model, a contention-free
schedule of a directed traffic graph is an *edge coloring*: transfers
sharing a source or a destination land in different phases.  Edge coloring
is distance-1 vertex coloring of the line graph, so the runtime schedules
its own communication with the paper's D1 algorithm
(:func:`repro_torch.core.distributed.color_single_device`, ``reference``
backend).  König's theorem gives the lower bound Δ = max port degree.

:func:`exchange_route_plan` turns such a schedule into the route tables
of the ``sparse_delta`` exchange and :func:`hierarchical_route_plan` the
per-level schedules of ``hier_delta``.  The line graph is colored on the
``device`` the caller names: the plan's own, so a plan on the CPU never
touches a card.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.distributed import color_single_device
from repro_torch.graph.csr import build_graph

__all__ = [
    "schedule_a2a",
    "phase_lower_bound",
    "RoutePlan",
    "exchange_route_plan",
    "HierRoutePlan",
    "hierarchical_route_plan",
]


def phase_lower_bound(traffic: np.ndarray) -> int:
    """Δ = max over ports of transfer count (König bound)."""
    sends = (traffic > 0).sum(axis=1)
    recvs = (traffic > 0).sum(axis=0)
    return int(max(sends.max(initial=0), recvs.max(initial=0)))


def schedule_a2a(
    traffic: np.ndarray, *, recolor_degrees: bool = True, device=None,
) -> list[list[tuple[int, int]]]:
    """Schedule the nonzero transfers of a (P, P) traffic matrix into
    contention-free phases.  Returns a list of phases, each a list of
    (src, dst) transfers with all sources and destinations distinct.

    ``device`` is where the line graph is colored (``None`` = ``cuda``).
    """
    srcs, dsts = np.nonzero(traffic)
    keep = srcs != dsts                  # local transfers need no phase
    srcs, dsts = srcs[keep], dsts[keep]
    n_edges = len(srcs)
    if n_edges == 0:
        return []
    # Line graph: edge-vertices conflict iff same src or same dst.
    by_src: dict[int, list[int]] = {}
    by_dst: dict[int, list[int]] = {}
    for i, (s, d) in enumerate(zip(srcs, dsts)):
        by_src.setdefault(int(s), []).append(i)
        by_dst.setdefault(int(d), []).append(i)
    e_src, e_dst = [], []
    for group in list(by_src.values()) + list(by_dst.values()):
        for a in range(len(group)):
            for b in range(a + 1, len(group)):
                e_src.append(group[a])
                e_dst.append(group[b])
    lg = build_graph(np.array(e_src), np.array(e_dst), n_edges)
    res = color_single_device(lg, problem="d1", recolor_degrees=recolor_degrees,
                              backend="reference", device=device)
    phases: dict[int, list[tuple[int, int]]] = {}
    for i, c in enumerate(res.colors[:n_edges]):
        phases.setdefault(int(c), []).append((int(srcs[i]), int(dsts[i])))
    out = [phases[c] for c in sorted(phases)]
    # Invariant: contention-free phases.
    for ph in out:
        ss = [s for s, _ in ph]
        dd = [d for _, d in ph]
        assert len(set(ss)) == len(ss) and len(set(dd)) == len(dd)
    return out


@dataclasses.dataclass(frozen=True)
class RoutePlan:
    """Static point-to-point routing for a (P, P) traffic graph.

    ``phases[k]`` is a contention-free list of ``(src, dst)`` transfers.
    ``dst_of``/``src_of`` are ``(n_phases, P)`` int32 tables: in phase
    ``k`` part ``p`` sends to ``dst_of[k, p]`` and receives from
    ``src_of[k, p]`` (−1 = idle).  ``edges`` is the full static edge set,
    each scheduled exactly once.
    """

    n_parts: int
    phases: tuple[tuple[tuple[int, int], ...], ...]
    dst_of: np.ndarray          # (n_phases, P) int32, -1 = no send
    src_of: np.ndarray          # (n_phases, P) int32, -1 = no recv
    edges: frozenset[tuple[int, int]]

    @property
    def n_phases(self) -> int:
        return len(self.phases)


def exchange_route_plan(
    traffic: np.ndarray, *, recolor_degrees: bool = True, device=None,
) -> RoutePlan:
    """Edge-color ``traffic`` (nonzero = must send) into a :class:`RoutePlan`.

    Every static owner→ghoster edge of the partition lands in exactly one
    phase, and within a phase all sources and destinations are distinct.
    """
    p = int(traffic.shape[0])
    phases = schedule_a2a(traffic, recolor_degrees=recolor_degrees, device=device)
    dst_of = np.full((len(phases), p), -1, dtype=np.int32)
    src_of = np.full((len(phases), p), -1, dtype=np.int32)
    for k, ph in enumerate(phases):
        for s, d in ph:
            dst_of[k, s] = d
            src_of[k, d] = s
    return RoutePlan(
        n_parts=p,
        phases=tuple(tuple(ph) for ph in phases),
        dst_of=dst_of,
        src_of=src_of,
        edges=frozenset(e for ph in phases for e in ph),
    )


@dataclasses.dataclass(frozen=True)
class HierRoutePlan:
    """Per-level phase schedules for a two-level (node, local) exchange.

    The ``P = n_nodes · node_size`` part axis factors into nodes of
    ``node_size`` consecutive parts (part ``p`` lives on node
    ``p // node_size``; part ``A·node_size`` is node ``A``'s leader):

    * ``intra``  — a :class:`RoutePlan` over the same-node traffic edges;
    * ``up``     — ``node_size - 1`` gather phases; ``up[j-1]`` sends
      member ``A·L + j`` → leader ``A·L`` on every node;
    * ``node``   — a :class:`RoutePlan` over the node-level aggregated
      traffic graph (``n_nodes`` wide): one leader→leader message per
      routed node pair;
    * ``down``   — ``node_size - 1`` broadcast phases; ``down[j-1]``
      sends leader ``A·L`` → member ``A·L + j`` on every node.
    """

    n_parts: int
    node_size: int
    n_nodes: int
    intra: RoutePlan            # part-level same-node traffic
    node: RoutePlan             # node-level aggregated cross traffic
    up: tuple[tuple[tuple[int, int], ...], ...]
    down: tuple[tuple[tuple[int, int], ...], ...]

    @property
    def n_phases(self) -> int:
        """Total phases one round executes across all levels."""
        return (self.intra.n_phases + len(self.up) + self.node.n_phases
                + len(self.down))

    def node_of(self, p: int) -> int:
        return p // self.node_size

    def leader_of(self, node: int) -> int:
        return node * self.node_size


def hierarchical_route_plan(
    traffic: np.ndarray, node_size: int, *, recolor_degrees: bool = True,
    device=None,
) -> HierRoutePlan:
    """Split a (P, P) traffic graph into the two-level phase schedules.

    ``traffic[o, q]`` nonzero means owner part ``o`` must reach part
    ``q``.  Same-node edges are edge-colored into the ``intra`` plan;
    cross-node edges are collapsed onto the node-level traffic graph
    (``node_traffic[A, B]`` = any part of ``A`` reaches any part of
    ``B``) and edge-colored at node granularity.
    """
    p = int(traffic.shape[0])
    if node_size < 1 or p % node_size:
        raise ValueError(
            f"node_size {node_size} must divide the part count {p}")
    n_nodes = p // node_size
    node = np.arange(p) // node_size
    same = node[:, None] == node[None, :]
    live = np.asarray(traffic) != 0
    kw = dict(recolor_degrees=recolor_degrees, device=device)
    intra = exchange_route_plan((live & same).astype(np.int64), **kw)
    node_traffic = np.zeros((n_nodes, n_nodes), dtype=np.int64)
    for o, q in zip(*np.nonzero(live & ~same)):
        node_traffic[node[o], node[q]] = 1
    node_plan = exchange_route_plan(node_traffic, **kw)
    ups = tuple(
        tuple((a * node_size + j, a * node_size) for a in range(n_nodes))
        for j in range(1, node_size)
    )
    downs = tuple(
        tuple((a * node_size, a * node_size + j) for a in range(n_nodes))
        for j in range(1, node_size)
    )
    return HierRoutePlan(
        n_parts=p, node_size=node_size, n_nodes=n_nodes,
        intra=intra, node=node_plan, up=ups, down=downs,
    )
