"""Ghost-exchange strategies for the distributed coloring loop.

The counterpart of ``repro/core/exchange.py``.  Each strategy is written
twice over the same index tables: ``stacked`` for the ``simulate`` engine
(part axis leading, one device) and ``device`` for the multi-GPU
``shard_map`` engine (one process per card under ``torch.distributed``,
each holding its own part as a stack of one).  Both return the same
ghosts and the same payload, measured per round:

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
reads nothing back.  On the ``device`` side every payload is already the
global one (summed over the ranks), so each rank books the same bytes.

The ``device`` transports map ``repro``'s ``lax`` collectives onto
``torch.distributed``: ``all_gather`` → ``all_gather_into_tensor``,
``ppermute`` → :func:`ppermute` (one ``batch_isend_irecv``), ``psum`` →
``all_reduce`` and the ragged all-to-all → ``all_to_all_single`` with
split sizes the host reads once a round.  Every wire buffer travels as
its raw bytes, so the narrow ``uint16`` wire dtype rides NCCL and gloo,
which have no such type.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

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
    "ppermute",
    "all_gather",
    "all_sum",
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


# --------------------------------------------------------------------------
# Transport over torch.distributed (the shard_map engine's collectives).
# --------------------------------------------------------------------------

def _raw(x: torch.Tensor) -> torch.Tensor:
    """``x``'s bytes as a flat ``uint8`` view sharing its storage."""
    return x.reshape(-1).view(torch.uint8)


def _wire_zeros(shape, dtype, device) -> torch.Tensor:
    """Zeros of any wire dtype, filled through their bytes (``uint16``
    tensors take only copies and views on every device)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    _raw(out).zero_()
    return out


def _peer(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def ppermute(x, pairs, group=None):
    """``lax.ppermute`` over the ranks of ``group``.

    ``pairs`` is a list of ``(src, dst)`` ranks of the group, with distinct
    sources, distinct destinations and ``src != dst``.  A rank sends ``x`` if it is a source and
    receives if it is a destination; a rank that is no destination gets
    zeros.  ``x`` may be a tensor or a tuple of tensors, all shipped to the
    same peer.  Every rank calls it with the same ``pairs``; the transfers
    are one ``batch_isend_irecv``, and a rank in no pair makes no call (an
    empty batch is an error).  Tensors move as their raw bytes.
    """
    xs = (x,) if isinstance(x, torch.Tensor) else tuple(x)
    outs = tuple(_wire_zeros(t.shape, t.dtype, t.device) for t in xs)
    rank = dist.get_rank(group)
    ops = []
    for s, d in pairs:
        if s == rank:
            ops += [dist.P2POp(dist.isend, _raw(t.contiguous()), _peer(group, d),
                               group) for t in xs]
        elif d == rank:
            ops += [dist.P2POp(dist.irecv, _raw(o), _peer(group, s), group)
                    for o in outs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return outs[0] if isinstance(x, torch.Tensor) else outs


def all_gather(x: torch.Tensor, n_parts: int, group=None) -> torch.Tensor:
    """``lax.all_gather``: ``(n_parts, *x.shape)``, row ``r`` from rank ``r``
    (one ``all_gather_into_tensor`` of the raw bytes)."""
    out = torch.empty((n_parts,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(_raw(out), _raw(x.contiguous()), group=group)
    return out


def all_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.psum``: ``x`` summed over the ranks (one ``all_reduce``)."""
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def _route_pair_phases(plan, ghost_tab, counts, slots, colors, *, group, scatter,
                       slot_dtype=COLOR_DTYPE, color_dtype=COLOR_DTYPE):
    """Execute a :class:`RoutePlan` over one rank's packed pair tables.

    ``counts (D,)``, ``slots (D, S)``, ``colors (D, S)`` are the rank's
    per-destination buffers (int32 in memory), ``ghost_tab (P, S)`` its
    per-owner slot tables.  Each phase ships one count-prefixed header at
    ``slot_dtype`` and the colors at ``color_dtype`` to ``dst_of[k][p]``
    (one :func:`ppermute` of both) and scatters the arrivals from
    ``src_of[k][p]`` into that owner's row, one ``pair_scatter`` of one
    row.  Shared by ``sparse_delta``'s phase loop (int32 wire) and
    ``hier_delta``'s intra stage (narrow wire).
    """
    p, s = dist.get_rank(group), slots.shape[-1]
    ar = torch.arange(s, dtype=COLOR_DTYPE, device=slots.device)
    ghost_tab = ghost_tab.clone()
    for k, phase in enumerate(plan.phases):
        dst, src = int(plan.dst_of[k][p]), int(plan.src_of[k][p])
        if dst < 0 and src < 0:
            continue
        d = max(dst, 0)
        head = torch.cat([counts[d:d + 1], slots[d]]).to(slot_dtype)
        r_head, r_cols = ppermute((head, colors[d].to(color_dtype)), phase, group)
        if src < 0:
            continue
        r_head = r_head.to(COLOR_DTYPE)
        idx = torch.where(ar < r_head[0], r_head[1:], s)       # pad -> drop
        ghost_tab[src] = apply_pairs(ghost_tab[src:src + 1], idx[None],
                                     r_cols.to(COLOR_DTYPE)[None], scatter=scatter)[0]
    return ghost_tab


def _ragged_pairs(ghost_tab, traffic_row, counts, slots, colors, *, group, n_parts,
                  scatter):
    """The single-shot transport: one ``all_to_all_single`` replaces the
    phase loop.

    A rank's row for destination ``d`` is the count followed by its
    ``(slot, color)`` pairs interleaved, trimmed to the ``1 + 2·count``
    words it counts (0 off the traffic graph), so exactly the measured
    payload crosses the wire.  The split sizes come from an all-gather of
    the size rows and are read on the host (one sync a round); the
    arrivals are scattered into ``ghost_tab (P, S)`` with one
    ``pair_scatter`` over all ``P`` owner rows.
    """
    p, s = dist.get_rank(group), slots.shape[-1]
    width = 1 + 2 * s
    rows = torch.cat([counts[:, None],
                      torch.stack([slots, colors], dim=-1).reshape(-1, 2 * s)], dim=1)
    send_sizes = torch.where(traffic_row > 0, 1 + 2 * counts, 0).to(COLOR_DTYPE)
    sizes = all_gather(send_sizes, n_parts, group).cpu()       # [src, dst]; the sync
    in_split, out_split = sizes[p].tolist(), sizes[:, p].tolist()
    inp = torch.cat([rows[d, :n] for d, n in enumerate(in_split)])
    out = inp.new_empty(sum(out_split))
    dist.all_to_all_single(out, inp, out_split, in_split, group=group)
    recv = rows.new_zeros((n_parts, width))
    for q, part in enumerate(torch.split(out, out_split)):
        recv[q, :part.numel()] = part
    pairs = recv[:, 1:].reshape(n_parts, s, 2)
    ar = torch.arange(s, dtype=COLOR_DTYPE, device=slots.device)
    idx = torch.where(ar[None, :] < recv[:, :1], pairs[..., 0], s)
    return apply_pairs(ghost_tab, idx, pairs[..., 1].contiguous(), scatter=scatter)


def _one_rank_ghosts(ghost_tab, st):
    """One rank's ghost colors ``(1, G)`` from its ``(P, S)`` slot tables."""
    ghost = ghost_tab[st["ghost_part"][0].to(torch.int64),
                      st["ghost_slot"][0].to(torch.int64)]
    return torch.where(st["ghost_real"], ghost[None], 0)


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
    returns ``(ghost (P, G), nbytes, state)``.  ``device`` is the
    per-process (shard_map) one: rank ``r`` holds row ``r`` of every table
    of ``st`` as a stack of one (``(1, ...)``; 0-d constants whole) and its
    colors ``(1, N)``, and returns ``(ghost (1, G), nbytes, state)`` with
    the global ``nbytes``; every rank of ``group`` calls it each round.
    Both give the same values, so the engines run the same math.
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

    def device(self, st, colors, state, *, group=None, n_parts):
        raise NotImplementedError

    def route_phases(self) -> tuple:
        """The static schedule the ``device`` transport follows (empty for
        the collective-only strategies); every rank must derive the same."""
        return ()


class AllGatherExchange(ExchangeStrategy):
    name = "all_gather"

    def prepare(self, pg, st, *, device=None):
        # Every round gathers the whole (P, S) send table: a fixed payload,
        # uploaded once so the round loop copies nothing from the host.
        p, s = st["send_idx"].shape
        return {"all_gather_bytes": np.asarray(payload_bytes(st, colors=p * s))}

    def stacked(self, st, colors, state):
        return _gathered_ghosts(colors, st), st["all_gather_bytes"], state

    def device(self, st, colors, state, *, group=None, n_parts):
        allbuf = all_gather(send_buffer(colors, st)[0], n_parts, group)   # (P, S)
        return _one_rank_ghosts(allbuf, st), st["all_gather_bytes"], state


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

    def device(self, st, colors, state, *, group=None, n_parts):
        send = send_buffer(colors, st)[0]
        p = dist.get_rank(group)
        from_prev = ppermute(send, [(i, i + 1) for i in range(n_parts - 1)], group)
        from_next = ppermute(send, [(i + 1, i) for i in range(n_parts - 1)], group)
        gs = st["ghost_slot"][0].to(torch.int64)
        ghost = torch.where(st["ghost_part"][0] < p, from_prev[gs], from_next[gs])
        return torch.where(st["ghost_real"], ghost[None], 0), st["halo_bytes"], state


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

    def device(self, st, colors, state, *, group=None, n_parts):
        send = send_buffer(colors, st)                            # (1, S)
        changed = st["send_mask"] & (send != state["prev_send"])
        ch_all = all_gather(changed[0], n_parts, group)           # (P, S) bits
        pay_all = all_gather(torch.where(changed, send, 0)[0], n_parts, group)
        gp = st["ghost_part"][0].to(torch.int64)
        gs = st["ghost_slot"][0].to(torch.int64)
        ghost_new = ch_all[gp, gs][None] & st["ghost_real"]
        ghost = torch.where(ghost_new, pay_all[gp, gs][None], state["prev_ghost"])
        nbytes = payload_bytes(st, colors=ch_all.sum(dtype=torch.int32),
                               masks=n_parts)
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

    ``ragged`` selects the ``device`` transport: ``"auto"`` or ``True``
    the single-shot ``all_to_all_single`` (torch always has it, so
    ``"auto"`` is the ragged path that ``repro`` takes where its jax has
    ``lax.ragged_all_to_all``), ``False`` the route plan's phase loop.
    Both move the same pairs, so results and bytes are identical.
    """

    name = "sparse_delta"

    def __init__(self, *, scatter: str = "reference", ragged: bool | str = "auto"):
        _check_scatter(scatter)
        if ragged not in (True, False, "auto"):
            raise ValueError(f"ragged must be True, False or 'auto', got {ragged!r}")
        self.scatter = scatter
        self.ragged = ragged
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

    def route_phases(self) -> tuple:
        return self._plan.phases

    def device(self, st, colors, state, *, group=None, n_parts):
        send = send_buffer(colors, st)                            # (1, S)
        changed = st["send_mask"] & (send != state["prev_send"])
        # One fixed-capacity buffer per destination: (P, S) each.
        slots, cols, counts = pack_pairs(changed & st["peer_need"][0], send)
        traffic_row = st["peer_traffic"][0]                       # (P,)
        hdr_prs = torch.stack([traffic_row.sum(dtype=torch.int32),
                               (traffic_row * counts).sum(dtype=torch.int32)])
        hdr, prs = all_sum(hdr_prs, group)
        nbytes = payload_bytes(st, headers=hdr, pairs=prs) // n_parts
        kw = dict(group=group, scatter=self.scatter)
        if self.ragged is False:
            ghost_tab = _route_pair_phases(self._plan, state["ghost_tab"][0], counts,
                                           slots, cols, **kw)
        else:
            ghost_tab = _ragged_pairs(state["ghost_tab"][0], traffic_row, counts,
                                      slots, cols, n_parts=n_parts, **kw)
        return (_one_rank_ghosts(ghost_tab, st), nbytes,
                {"prev_send": send, "ghost_tab": ghost_tab[None]})


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

    ``device`` runs the four stages as ``repro``'s does: the intra stage
    over the intra route plan's phases at the narrow wire dtypes, or, with
    ``ragged=True``, as one ``all_to_all_single`` of the same-node pairs
    (int32 rows; ``repro`` has only the phase loop, the default); the up,
    inter and down stages as :func:`ppermute` phases.
    """

    name = "hier_delta"

    def __init__(self, *, scatter: str = "reference",
                 node_size: int | None = None, ragged: bool = False):
        _check_scatter(scatter)
        if ragged not in (True, False):
            raise ValueError(f"ragged must be True or False, got {ragged!r}")
        self.scatter = scatter
        self.node_size = node_size
        self.ragged = ragged
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
                            leader_agg], axis=1).astype(np.int32)  # (P, 2, P)
        a_hdr = self._agg_traffic.sum(axis=1)
        self._headers = (int(self._intra_traffic.sum() + (up_down * a_hdr).sum()),
                         int(a_hdr.sum()))
        return {"hier_reach": reach, "hier_weights": weights,
                "hier_intra": self._intra_traffic.astype(np.int32),
                "hier_agg": self._agg_traffic.astype(np.int32)}

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
        prs = (st["hier_weights"] * counts[:, None, :]).sum(dim=(0, 2),
                                                           dtype=torch.int32)
        kw = dict(color_dtype=self._color_dtype, slot_dtype=self._slot_dtype)
        nbytes = torch.stack([
            payload_bytes(st, headers=self._headers[0], pairs=prs[0], **kw),
            payload_bytes(st, headers=self._headers[1], pairs=prs[1], **kw),
        ]) // p_
        ghost = _gather_ghosts(ghost_tab, st)
        return ghost, nbytes, {"prev_send": send, "ghost_tab": ghost_tab}

    def route_phases(self) -> tuple:
        hp = self._hplan
        return (hp.node_size, hp.intra.phases, hp.node.phases, hp.up, hp.down)

    def device(self, st, colors, state, *, group=None, n_parts):
        hp, s, l = self._hplan, st["send_idx"].shape[-1], self._l
        p = dist.get_rank(group)
        my_node, is_leader = p // l, p % l == 0
        wire = dict(slot_dtype=self._slot_dtype, color_dtype=self._color_dtype)
        send = send_buffer(colors, st)                            # (1, S)
        changed = st["send_mask"] & (send != state["prev_send"])
        # reach[p, q] is the direct need on same-node edges and node B's
        # aggregated need at B's leader column (see prepare).
        reach = changed & st["hier_reach"][0]                     # (P, S)
        node = torch.arange(n_parts, device=send.device) // l
        intra_row = st["hier_intra"][0]                           # (P,)
        agg_row = st["hier_agg"][0]                               # (N,)

        # Stage 1 — direct same-node pairs, over the intra plan.
        d_slots, d_cols, d_counts = pack_pairs(reach & (node == my_node)[:, None], send)
        if self.ragged:
            ghost_tab = _ragged_pairs(state["ghost_tab"][0], intra_row, d_counts,
                                      d_slots, d_cols, group=group, n_parts=n_parts,
                                      scatter=self.scatter)
        else:
            ghost_tab = _route_pair_phases(hp.intra, state["ghost_tab"][0], d_counts,
                                           d_slots, d_cols, group=group,
                                           scatter=self.scatter, **wire)

        # Per-destination-node aggregated tables (the dedup win).
        a_slots, a_cols, a_counts = pack_pairs(
            reach[::l] & (agg_row > 0)[:, None], send)           # (N, S)

        # Measured bytes: each aggregated table pays one up hop (members
        # only), one inter hop and node_size - 1 down hops, booked against
        # its owner; the summed total is exact.
        up_down = (0 if is_leader else 1) + (l - 1)
        d_hdr = intra_row.sum(dtype=torch.int32)
        d_prs = (intra_row * d_counts).sum(dtype=torch.int32)
        a_hdr = agg_row.sum(dtype=torch.int32)
        a_prs = (agg_row * a_counts).sum(dtype=torch.int32)
        h_intra, p_intra, h_inter, p_inter = all_sum(torch.stack(
            [d_hdr + up_down * a_hdr, d_prs + up_down * a_prs, a_hdr, a_prs]), group)
        nbytes = torch.stack([
            payload_bytes(st, headers=h_intra, pairs=p_intra, **wire),
            payload_bytes(st, headers=h_inter, pairs=p_inter, **wire),
        ]) // n_parts

        # Stage 2 — up: members ship their typed tables to the leader,
        # which keeps them as int32 (row 0 its own, row j member A·L + j's).
        head0 = torch.cat([a_counts[:, None], a_slots], dim=1)     # (N, 1+S)
        up = [(head0, a_cols)]
        for perm in hp.up:
            h, c = ppermute((head0.to(self._slot_dtype), a_cols.to(self._color_dtype)),
                            perm, group)
            up.append((h.to(COLOR_DTYPE), c.to(COLOR_DTYPE)))

        # Stage 3 — inter: one leader→leader block (node_size member tables)
        # per routed node edge, accumulated owner-major.
        arr_head = _wire_zeros((n_parts, 1 + s), self._slot_dtype, send.device)
        arr_cols = _wire_zeros((n_parts, s), self._color_dtype, send.device)
        for k, phase in enumerate(hp.node.phases):
            dstn = int(hp.node.dst_of[k][my_node]) if is_leader else -1
            srcn = int(hp.node.src_of[k][my_node]) if is_leader else -1
            if dstn < 0 and srcn < 0:
                continue
            db = max(dstn, 0)
            blk = (torch.stack([h[db] for h, _ in up]).to(self._slot_dtype),
                   torch.stack([c[db] for _, c in up]).to(self._color_dtype))
            r_head, r_cols = ppermute(blk, [(a * l, b * l) for a, b in phase], group)
            if srcn >= 0:
                arr_head[srcn * l:(srcn + 1) * l] = r_head
                arr_cols[srcn * l:(srcn + 1) * l] = r_cols

        # Stage 4 — down: the leader re-broadcasts the arrivals.
        for j, perm in enumerate(hp.down, start=1):
            r_head, r_cols = ppermute((arr_head, arr_cols), perm, group)
            if p % l == j:
                arr_head, arr_cols = r_head, r_cols

        # Apply every arrived row, one pair_scatter over the P owner rows;
        # pairs this part never ghosts land in entries the ghost gather
        # never reads (and carry the owner's true colors regardless).
        arr_head = arr_head.to(COLOR_DTYPE)
        ar = torch.arange(s, dtype=COLOR_DTYPE, device=send.device)
        idx = torch.where(ar[None, :] < arr_head[:, :1], arr_head[:, 1:], s)
        ghost_tab = apply_pairs(ghost_tab, idx, arr_cols.to(COLOR_DTYPE),
                                scatter=self.scatter)
        return (_one_rank_ghosts(ghost_tab, st), nbytes,
                {"prev_send": send, "ghost_tab": ghost_tab[None]})


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
