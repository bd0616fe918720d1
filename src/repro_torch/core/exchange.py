"""Ghost-exchange strategies for the distributed coloring loop.

This slice ports the ``all_gather`` strategy in its stacked (``simulate``)
form: every part broadcasts its send buffer and ghosts are a static
``(owner_part, send_slot)`` gather from the gathered table.  Measured
bytes per device per round: ``P·S·4``.  The sparse strategies and the
multi-GPU form are still to port (ROADMAP.md, queues 4 and 8).

Every strategy returns a *measured* per-round byte count through the
shared :func:`payload_bytes` schema — a scalar, or a ``[intra-node,
inter-node]`` pair which :func:`level_split` normalizes for the round
loop.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.registry import Registry

__all__ = [
    "ExchangeStrategy",
    "AllGatherExchange",
    "EXCHANGES",
    "get_exchange",
    "list_exchanges",
    "register_exchange",
    "send_buffer",
    "payload_bytes",
    "wire_dtype",
    "dtype_bytes",
    "level_split",
]

COLOR_DTYPE = torch.int32          # in-memory dtype for colors/slots


def wire_dtype(bound: int) -> torch.dtype:
    """Narrowest wire dtype that represents every value in ``0..bound``."""
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
    """Payload bytes under one shared schema (``np.int32`` scalar).

    ``colors`` counts bare color words (at ``color_dtype`` width),
    ``headers`` counts buffer count-prefix words (at ``slot_dtype``
    width), ``pairs`` counts ``(slot-id, color)`` tuples (one word of
    each dtype), and ``masks`` counts whole changed-bitmasks over the
    send width.  ``st`` may hold numpy arrays or tensors; only the send
    width is read.  A strategy whose payload is fixed per plan computes
    it once, in :meth:`ExchangeStrategy.prepare`.
    """
    s = st["send_idx"].shape[-1]
    cb, sb = dtype_bytes(color_dtype), dtype_bytes(slot_dtype)
    total = (cb * colors + sb * headers + (cb + sb) * pairs
             + masks * ((s + 7) // 8))
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


class ExchangeStrategy:
    """Interface: one ghost exchange per round, with measured byte count.

    ``stacked`` is the part-axis-leading (simulate) implementation; it
    returns ``(ghost (P, G), nbytes, state)``.
    """

    name: str = "abstract"

    def prepare(self, pg, st):
        """Host-side setup before the loop: extra numpy arrays to merge
        into the device state, stacked ``(P, ...)`` tables or 0-d
        constants uploaded once per plan."""
        return {}

    def init_state(self, st):
        """Loop-carried exchange state (shapes follow ``st``'s layout)."""
        return ()

    def stacked(self, st, colors, state):
        raise NotImplementedError


class AllGatherExchange(ExchangeStrategy):
    name = "all_gather"

    def prepare(self, pg, st):
        # Every round gathers the whole (P, S) send table: a fixed payload,
        # uploaded once so the round loop copies nothing from the host.
        p, s = st["send_idx"].shape
        return {"all_gather_bytes": np.asarray(payload_bytes(st, colors=p * s))}

    def stacked(self, st, colors, state):
        allbuf = send_buffer(colors, st)                          # (P, S)
        ghost = allbuf[st["ghost_part"].to(torch.int64),
                       st["ghost_slot"].to(torch.int64)]
        ghost = torch.where(st["ghost_real"], ghost, 0)
        return ghost, st["all_gather_bytes"], state


EXCHANGES: Registry = Registry(
    "exchange",
    {"all_gather": AllGatherExchange},
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


def get_exchange(exchange: str | ExchangeStrategy | None) -> ExchangeStrategy:
    """Resolve ``exchange`` (name, instance, or None → all_gather)."""
    return EXCHANGES.resolve(exchange)
