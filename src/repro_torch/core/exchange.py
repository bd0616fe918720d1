"""Ghost-exchange strategies for the distributed coloring loop.

The stacked (``simulate``) half of ``repro/core/exchange.py``: every
strategy works over the part axis leading on one device and returns the
payload its multi-device form would move, measured per round:

* ``all_gather``   — every part broadcasts its send buffer; ghosts are a
  static ``(owner_part, send_slot)`` gather.  Bytes/device/round:
  ``P·S·4``.
* ``halo``         — two-way neighbor exchange for slab partitions (ghosts
  only on parts p±1).  Bytes/device/round: ``2·S·4``.
* ``delta``        — iterative-recoloring communication reduction: after
  the first round only boundary colors that *changed* are exchanged and
  receivers patch their ghost table.  Bytes: ``4·(global changed) +
  P·⌈S/8⌉`` (a mask+words wire format).
* ``sparse_delta`` — changed boundary colors packed as count-prefixed
  ``(send-slot-id, color)`` pairs per destination (:func:`pack_pairs`),
  routed over the edge-colored plan of
  ``core.a2a_schedule.exchange_route_plan``, and scattered into per-owner
  slot tables (:func:`apply_pairs`; ``scatter="cuda"``, the choice of a
  name under a kernel backend, runs the ``pair_scatter`` kernel).
  Bytes: ``4·Σ_edges(1 + 2·sent) / P``.
* ``hier_delta``   — the two-level hierarchy over a ``(node, local)``
  factorization of the part axis (``launch.mesh.factor_parts``): same-node
  pairs direct, cross-node pairs aggregated per destination node, shipped
  member→leader→leader→members (``core.a2a_schedule.
  hierarchical_route_plan``).  Colors and slots ride the narrowest wire
  dtype their static bounds admit (:func:`wire_dtype`), and the bytes,
  split ``[intra-node, inter-node]``, come from those packed widths.

Every strategy returns its payload through the shared
:func:`payload_bytes` schema — a scalar, or a ``[intra-node, inter-node]``
pair which :func:`level_split` normalizes for the round loop.  Payloads
that change per round are int32 tensors on the plan's device, so the loop
reads nothing back.  Each strategy's multi-GPU form (``device``), the
phase-by-phase transport and the ragged all-to-all belong to the multi-GPU
engine (ROADMAP.md, queue 1 item 8).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.registry import Registry
from repro_torch.graph.csr import SENTINEL
from repro_torch.kernels.scatter import pair_scatter, pair_scatter_ref

__all__ = [
    "ExchangeStrategy",
    "AllGatherExchange",
    "HaloExchange",
    "DeltaExchange",
    "SparseDeltaExchange",
    "HierDeltaExchange",
    "EXCHANGES",
    "SCATTERS",
    "get_exchange",
    "list_exchanges",
    "register_exchange",
    "send_buffer",
    "payload_bytes",
    "wire_dtype",
    "dtype_bytes",
    "level_split",
    "pack_pairs",
    "apply_pairs",
]

COLOR_DTYPE = torch.int32          # in-memory dtype for colors/slots
# How received pairs are applied: the plain version, or the pair_scatter
# kernel (repro's "pallas").
SCATTERS = ("reference", "cuda")


def wire_dtype(bound: int) -> torch.dtype:
    """Narrowest wire dtype that represents every value in ``0..bound``.

    ``hier_delta`` calls it with the static palette bound (first-fit:
    ``Δ+1`` for D1-family problems, ``Δ²+1`` for the distance-2 family)
    to pick the color wire dtype and with the send capacity ``S`` (the
    pad sentinel) to pick the slot/count wire dtype.
    """
    if bound < 0:
        raise ValueError(f"wire bound must be >= 0, got {bound}")
    if bound <= np.iinfo(np.uint8).max:
        return torch.uint8
    if bound <= np.iinfo(np.uint16).max:
        return torch.uint16
    return COLOR_DTYPE


def dtype_bytes(dtype) -> int:
    """Bytes per element of a wire dtype (the one itemsize rule)."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return int(np.dtype(dtype).itemsize)


def send_buffer(colors, st):
    """Pack the colors other parts need into the static send layout.

    Stacked: ``colors (P, N)`` → ``(P, S)``.
    """
    return torch.where(st["send_mask"],
                       torch.gather(colors, 1, st["send_idx"].to(torch.int64)), 0)


def payload_bytes(st, *, colors=0, masks=0, headers=0, pairs=0,
                  color_dtype=COLOR_DTYPE, slot_dtype=COLOR_DTYPE):
    """Payload bytes under one shared schema.

    ``colors`` counts bare color words (at ``color_dtype`` width),
    ``headers`` counts buffer count-prefix words (at ``slot_dtype``
    width), ``pairs`` counts ``(slot-id, color)`` tuples (one word of
    each dtype), and ``masks`` counts whole changed-bitmasks over the
    send width.  Counts are Python ints or int32 tensors.  With a tensor
    count the result is an int32 tensor on its device, computed there
    (no host sync), with int32 arithmetic as in ``repro``; with Python
    ints only, an ``np.int32`` — a payload fixed per plan, which a
    strategy computes once in :meth:`ExchangeStrategy.prepare`.  ``st``
    may hold numpy arrays or tensors; only the send width is read.
    """
    s = st["send_idx"].shape[-1]
    cb, sb = dtype_bytes(color_dtype), dtype_bytes(slot_dtype)
    total = (cb * colors + sb * headers + (cb + sb) * pairs
             + masks * ((s + 7) // 8))
    if isinstance(total, torch.Tensor):
        return total.to(torch.int32)
    return np.int32(total)


def level_split(nbytes) -> torch.Tensor:
    """Normalize a strategy's byte return to the ``[intra, inter]`` pair.

    Flat strategies return a scalar — booked entirely as *inter-node*;
    hierarchical strategies return the shape-(2,) split directly.
    """
    nbytes = torch.as_tensor(nbytes)
    if nbytes.ndim == 0:
        return torch.stack([torch.zeros_like(nbytes), nbytes])
    return nbytes


def pack_pairs(take, send):
    """Front-pack changed slots as (slot-id, color) pairs, per destination.

    ``take (..., S)`` selects the slots of each buffer; ``send`` holds
    their colors, broadcastable to ``take``.  Returns ``(slots, colors,
    count)`` with capacity ``S``: the first ``count`` entries of a buffer
    are its selected slot ids in ascending order with their colors;
    padding carries the out-of-range sentinel slot ``S`` (dropped by
    :func:`apply_pairs`).  The sort key is unique per slot, so any sort
    gives ``repro``'s order.
    """
    s = take.shape[-1]
    ar = torch.arange(s, dtype=COLOR_DTYPE, device=take.device)
    count = take.sum(-1, dtype=COLOR_DTYPE)
    key = (~take).to(COLOR_DTYPE) * (s + 1) + ar
    order = torch.argsort(key, dim=-1)
    valid = ar < count[..., None]
    slots = torch.where(valid, order.to(COLOR_DTYPE), s)
    colors = torch.where(valid, torch.gather(send.expand(take.shape), -1, order), 0)
    return slots, colors.to(COLOR_DTYPE), count


def _check_scatter(scatter: str) -> None:
    if scatter not in SCATTERS:
        raise ValueError(f"scatter must be one of {SCATTERS}, got {scatter!r}")


def apply_pairs(table, slots, colors, *, scatter: str = "reference"):
    """Scatter received (slot-id, color) pairs into slot tables.

    Batched over leading axes (``table (..., S)``, pairs ``(..., C)``).
    Padded pairs carry slot id >= ``S`` and are dropped.  ``scatter``
    selects the plain version or the ``pair_scatter`` kernel
    (``"cuda"``; on CPU tensors it runs the plain version) — both produce
    identical tables.
    """
    _check_scatter(scatter)
    fn = pair_scatter if scatter == "cuda" else pair_scatter_ref
    return fn(table, slots, colors)


def _stacked_pair_apply(ghost_tab, take, send, *, scatter):
    """Pack and deliver pair tables in the stacked (simulate) view.

    ``take (P, D, S)`` selects, owner-major, which send slots each of
    ``D`` destinations receives; ``send (P, S)`` are the owner send
    buffers.  Returns the receiver-major patched ``ghost_tab (D, P, S)``
    plus the owner-major pair counts ``(P, D)`` for byte accounting.  All
    ``D·P`` rows are delivered by one :func:`apply_pairs` call (one kernel
    launch).  ``take`` is empty off the traffic graph by construction, so
    ``repro``'s mask of the edges that ship changes nothing here and is
    not applied.
    """
    slots, cols, counts = pack_pairs(take, send[:, None, :])   # [owner, dest]
    table = apply_pairs(ghost_tab, slots.transpose(0, 1), cols.transpose(0, 1),
                        scatter=scatter)
    return table, counts


def _gathered_ghosts(colors, st):
    """Ghost colors gathered from every part's send buffer (``(P, G)``)."""
    allbuf = send_buffer(colors, st)                              # (P, S)
    ghost = allbuf[st["ghost_part"].to(torch.int64), st["ghost_slot"].to(torch.int64)]
    return torch.where(st["ghost_real"], ghost, 0)


def _gather_ghosts(ghost_tab, st):
    """Ghost colors from receiver-major slot tables ``(P, P, S)``."""
    p = ghost_tab.shape[0]
    rows = torch.arange(p, device=ghost_tab.device)[:, None]
    ghost = ghost_tab[rows, st["ghost_part"].to(torch.int64),
                      st["ghost_slot"].to(torch.int64)]
    return torch.where(st["ghost_real"], ghost, 0)


def _peer_need(pg) -> np.ndarray:
    """``need[owner, dest, slot]``: part ``dest`` ghosts ``owner``'s send slot."""
    p_, s_ = pg.n_parts, pg.send_width
    need = np.zeros((p_, p_, s_), dtype=bool)
    for q in range(p_):
        real = pg.ghost_gid[q] != SENTINEL
        need[pg.ghost_part[q][real], q, pg.ghost_slot[q][real]] = True
    return need


def _zeros(st, key):
    """Int32 zeros shaped like ``st[key]``, on its device."""
    return torch.zeros(tuple(st[key].shape), dtype=COLOR_DTYPE, device=st[key].device)


class ExchangeStrategy:
    """Interface: one ghost exchange per round, with measured byte count.

    ``stacked`` is the part-axis-leading (simulate) implementation; it
    returns ``(ghost (P, G), nbytes, state)``.
    """

    name: str = "abstract"
    requires_slab: bool = False

    def prepare(self, pg, st, *, device=None):
        """Host-side setup before the loop: extra numpy arrays to merge
        into the device state, stacked ``(P, ...)`` tables or 0-d
        constants uploaded once per plan.  ``device`` is the plan's device
        (``None`` = ``cuda``); route plans are colored there."""
        return {}

    def init_state(self, st):
        """Loop-carried exchange state, on the device of ``st``'s tensors."""
        return ()

    def stacked(self, st, colors, state):
        raise NotImplementedError


class AllGatherExchange(ExchangeStrategy):
    name = "all_gather"

    def prepare(self, pg, st, *, device=None):
        # Every round gathers the whole (P, S) send table: a fixed payload,
        # uploaded once so the round loop copies nothing from the host.
        p, s = st["send_idx"].shape
        return {"all_gather_bytes": np.asarray(payload_bytes(st, colors=p * s))}

    def stacked(self, st, colors, state):
        return _gathered_ghosts(colors, st), st["all_gather_bytes"], state


class HaloExchange(ExchangeStrategy):
    """Two-way slab halo: each part talks only to p-1 and p+1."""

    name = "halo"
    requires_slab = True

    def prepare(self, pg, st, *, device=None):
        s = st["send_idx"].shape[-1]
        return {"halo_bytes": np.asarray(payload_bytes(st, colors=2 * s))}

    def stacked(self, st, colors, state):
        # Slab validity is checked up front, so every ghost's owner is p±1
        # and the gathered values coincide with the two neighbor sends;
        # only the byte accounting differs from all_gather.
        return _gathered_ghosts(colors, st), st["halo_bytes"], state


class DeltaExchange(ExchangeStrategy):
    """Changed-colors-only exchange (communication-reducing recoloring).

    Round 0 ships every real send slot (all colors are new); afterwards a
    slot is shipped only if its color differs from the previous round, and
    receivers patch the stale entries of their ghost table.  The carried
    state is (previous send buffer, previous ghost table).
    """

    name = "delta"

    def init_state(self, st):
        return {"prev_send": _zeros(st, "send_idx"),
                "prev_ghost": _zeros(st, "ghost_part")}

    def stacked(self, st, colors, state):
        send = send_buffer(colors, st)                            # (P, S)
        changed = st["send_mask"] & (send != state["prev_send"])
        payload = torch.where(changed, send, 0)
        gp = st["ghost_part"].to(torch.int64)
        gs = st["ghost_slot"].to(torch.int64)
        ghost_new = changed[gp, gs] & st["ghost_real"]
        ghost = torch.where(ghost_new, payload[gp, gs], state["prev_ghost"])
        nbytes = payload_bytes(st, colors=changed.sum(dtype=torch.int32),
                               masks=send.shape[0])
        return ghost, nbytes, {"prev_send": send, "prev_ghost": ghost}


class SparseDeltaExchange(ExchangeStrategy):
    """Sparse delta all-to-all of ``(send-slot-id, color)`` pairs.

    Per round, each part packs the pairs of boundary vertices whose color
    changed since the previous round into a fixed-capacity count-prefixed
    buffer per destination (capacity = send width ``S``) that needs them;
    the buffers ride the edge-colored route plan built by
    :func:`repro_torch.core.a2a_schedule.exchange_route_plan` from the
    static owner→ghoster traffic graph.  Receivers scatter the pairs into
    a per-owner slot table (``ghost_tab[owner, slot]`` = last color
    heard) and gather ghosts from it, so the reconstruction is exact:
    identical colorings and round counts to ``all_gather``.

    Loop-carried state: the previous send buffer plus the per-peer slot
    tables.  Measured bytes are the count-prefixed payload moved (``1 +
    2·count`` words per routed edge), averaged per part.  ``scatter``
    selects how received pairs are applied: ``"reference"`` (plain
    PyTorch) or ``"cuda"`` (the ``pair_scatter`` kernel, one launch per
    round for all ``(P, P)`` tables).
    """

    name = "sparse_delta"

    def __init__(self, *, scatter: str = "reference"):
        _check_scatter(scatter)
        self.scatter = scatter
        self._plan = None
        self._traffic = None

    def prepare(self, pg, st, *, device=None):
        from repro_torch.core.a2a_schedule import exchange_route_plan

        need = _peer_need(pg)
        traffic = need.any(axis=2)
        self._plan = exchange_route_plan(traffic.astype(np.int64), device=device)
        self._traffic = traffic
        self._headers = int(traffic.sum())
        return {"peer_need": need, "peer_traffic": traffic.astype(np.int32)}

    def init_state(self, st):
        if "peer_need" not in st:
            raise ValueError(
                "sparse_delta needs its prepare() tables; run it through "
                "color_distributed (or call prepare(pg, st) first)"
            )
        return {
            "prev_send": _zeros(st, "send_idx"),
            # Per-peer slot tables, receiver-major (P, P, S).
            "ghost_tab": _zeros(st, "peer_need"),
        }

    def stacked(self, st, colors, state):
        p_ = st["send_idx"].shape[0]
        send = send_buffer(colors, st)                            # (P, S)
        changed = st["send_mask"] & (send != state["prev_send"])
        take = changed[:, None, :] & st["peer_need"]              # (P, P, S)
        # Receiver view: ghost_tab[r, o] patched with the pairs o -> r.
        ghost_tab, counts = _stacked_pair_apply(
            state["ghost_tab"], take, send, scatter=self.scatter)
        prs = (st["peer_traffic"] * counts).sum(dtype=torch.int32)
        nbytes = payload_bytes(st, headers=self._headers, pairs=prs) // p_
        ghost = _gather_ghosts(ghost_tab, st)
        return ghost, nbytes, {"prev_send": send, "ghost_tab": ghost_tab}


class HierDeltaExchange(ExchangeStrategy):
    """Two-level hierarchical sparse delta over a (node, local) factoring.

    The part axis factors into ``n_nodes`` nodes of ``node_size`` parts
    (``launch.mesh.factor_parts``; part ``p`` lives on node
    ``p // node_size``, part ``A·node_size`` is node ``A``'s leader).  On
    the multi-device engine each round runs four stages over the schedules
    of :func:`repro_torch.core.a2a_schedule.hierarchical_route_plan`:
    direct same-node pairs; each member's per-destination-**node**
    aggregated pair tables up to its leader (a boundary slot ghosted by
    several parts of node B is packed once for B); one leader→leader
    message per routed node edge; the leader's re-broadcast to its
    members.  The stacked view reproduces the stages' net effect in one
    pack+scatter pass: part ``q`` hears owner ``o``'s direct need on
    same-node edges and the node-aggregated need everywhere else (the
    extra entries land in table rows the ghost gather never reads, so the
    reconstruction is exact).

    On the wire, colors ride the narrowest dtype the static palette bound
    admits (first-fit: ``Δ+1`` for the d1 family, ``Δ²+1`` for
    distance-2) and slot ids/counts the narrowest width the send capacity
    admits (:func:`wire_dtype`), so the measured bytes come from the
    packed widths although the stacked view moves int32.  ``nbytes`` is
    the shape-(2,) ``[intra-node, inter-node]`` split: direct, up and down
    traffic on the fast axis, the leader→leader hop on the slow one; an
    aggregated table pays one up hop (members only), one inter hop and
    ``node_size - 1`` down hops, booked against its owner.

    ``node_size=None`` defers to :func:`repro_torch.launch.mesh.
    factor_parts` (env ``REPRO_NODE_SIZE``, else the squarest divisor).
    """

    name = "hier_delta"

    def __init__(self, *, scatter: str = "reference",
                 node_size: int | None = None):
        _check_scatter(scatter)
        self.scatter = scatter
        self.node_size = node_size
        self._hplan = None

    def prepare(self, pg, st, *, device=None):
        from repro_torch.core.a2a_schedule import hierarchical_route_plan
        from repro_torch.launch.mesh import factor_parts

        p_ = pg.n_parts
        need = _peer_need(pg)
        traffic = need.any(axis=2)
        n_nodes, node_size = factor_parts(p_, self.node_size)
        self._n, self._l = n_nodes, node_size
        self._hplan = hierarchical_route_plan(
            traffic.astype(np.int64), node_size, device=device)
        node = np.arange(p_) // node_size
        same = node[:, None] == node[None, :]
        # agg_need[owner, B, slot]: some part of *other* node B ghosts it.
        agg_need = np.stack([need[:, node == b, :].any(axis=1)
                             for b in range(n_nodes)], axis=1)
        agg_need[np.arange(p_), node, :] = False   # same node -> direct path
        self._intra_traffic = traffic & same                     # (P, P)
        self._agg_traffic = agg_need.any(axis=2)                 # (P, N)
        # reach[o, q]: q hears o's pairs (directly or via B's broadcast).
        self._reach_traffic = self._intra_traffic | self._agg_traffic[:, node]
        reach = np.where(same[:, :, None], need, agg_need[:, node, :])
        # Packed wire widths from static bounds: palette = first-fit bound
        # (colors are 0 = uncolored or 1..bound), slots/counts = send
        # capacity S (the pad sentinel is the largest value shipped).
        delta = int(np.max(pg.deg, initial=0))
        palette = delta * delta + 1 if "two_hop_cidx" in st else delta + 1
        self._color_dtype = wire_dtype(palette)
        self._slot_dtype = wire_dtype(pg.send_width)
        # Byte weights over the (owner, dest) pair counts: same-node edges
        # carry the direct tables; the leader column of another node B
        # carries the owner's aggregated table for B, which pays up + down
        # hops (intra) and one inter hop.
        member = (np.arange(p_) % node_size != 0).astype(np.int32)
        up_down = member + (node_size - 1)                       # (P,)
        leader_agg = np.zeros((p_, p_), dtype=np.int32)
        leader_agg[:, np.arange(n_nodes) * node_size] = self._agg_traffic
        weights = np.stack([self._intra_traffic + up_down[:, None] * leader_agg,
                            leader_agg]).astype(np.int32)        # (2, P, P)
        a_hdr = self._agg_traffic.sum(axis=1)
        self._headers = (int(self._intra_traffic.sum() + (up_down * a_hdr).sum()),
                         int(a_hdr.sum()))
        return {"hier_reach": reach, "hier_weights": weights}

    def init_state(self, st):
        if "hier_reach" not in st:
            raise ValueError(
                "hier_delta needs its prepare() tables; run it through "
                "color_distributed (or call prepare(pg, st) first)"
            )
        return {
            "prev_send": _zeros(st, "send_idx"),
            # Per-owner slot tables, receiver-major (P, P, S).
            "ghost_tab": _zeros(st, "hier_reach"),
        }

    def stacked(self, st, colors, state):
        p_ = st["send_idx"].shape[0]
        send = send_buffer(colors, st)                            # (P, S)
        changed = st["send_mask"] & (send != state["prev_send"])
        take = changed[:, None, :] & st["hier_reach"]             # (P, P, S)
        ghost_tab, counts = _stacked_pair_apply(
            state["ghost_tab"], take, send, scatter=self.scatter)
        prs = (st["hier_weights"] * counts).sum(dim=(1, 2), dtype=torch.int32)
        kw = dict(color_dtype=self._color_dtype, slot_dtype=self._slot_dtype)
        nbytes = torch.stack([
            payload_bytes(st, headers=self._headers[0], pairs=prs[0], **kw),
            payload_bytes(st, headers=self._headers[1], pairs=prs[1], **kw),
        ]) // p_
        ghost = _gather_ghosts(ghost_tab, st)
        return ghost, nbytes, {"prev_send": send, "ghost_tab": ghost_tab}


EXCHANGES: Registry = Registry(
    "exchange",
    {
        "all_gather": AllGatherExchange,
        "halo": HaloExchange,
        "delta": DeltaExchange,
        "sparse_delta": SparseDeltaExchange,
        "hier_delta": HierDeltaExchange,
    },
    instance_of=ExchangeStrategy,
    instantiate=True,
    default="all_gather",
)


def register_exchange(name: str, cls: type[ExchangeStrategy]) -> None:
    """Register a third-party :class:`ExchangeStrategy` under ``name``."""
    EXCHANGES.register(name, cls)


def list_exchanges() -> list[str]:
    """Sorted registered exchange names (drives the CLI choices)."""
    return EXCHANGES.names()


def get_exchange(exchange: str | ExchangeStrategy | None,
                 backend: str = "reference") -> ExchangeStrategy:
    """Resolve ``exchange`` (name, instance, or None → all_gather).

    A sparse exchange given by name under a kernel backend (any but
    ``reference``) scatters received pairs with the ``pair_scatter``
    kernel; an instance keeps its own ``scatter``.  The two names so fix
    the whole strategy, and a plan key that holds both fingerprints it.
    """
    strategy = EXCHANGES.resolve(exchange)
    if (not isinstance(exchange, ExchangeStrategy) and backend != "reference"
            and isinstance(strategy, (SparseDeltaExchange, HierDeltaExchange))):
        strategy.scatter = "cuda"
    return strategy
