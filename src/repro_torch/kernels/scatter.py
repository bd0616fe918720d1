"""``pair_scatter`` — apply ``(slot-id, value)`` pairs to slot tables.

The CUDA kernel (``csrc/pair_scatter.cu``) replaces the TPU kernel
``repro/kernels/scatter.py::pair_scatter``; :func:`pair_scatter_ref` is its
plain-PyTorch version, the counterpart of
``repro/kernels/ref.py::pair_scatter_ref``.  The port's functions are
batched over leading axes: a table ``(..., S)`` takes pairs ``(..., C)``
with the same leading axes, so the stacked ``(P, P, S)`` ghost tables of
the sparse exchanges take one launch per round.  The receive step of
``SparseDeltaExchange(scatter="cuda")`` and
``HierDeltaExchange(scatter="cuda")`` runs through :func:`pair_scatter`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import check_tensor, on_cpu
from repro_torch.kernels.build import load

__all__ = ["pair_scatter", "pair_scatter_ref", "launch_kernel"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_ARGTYPES = [_P, _I64, _P, _P, _P, _I64, ctypes.c_int, ctypes.c_int, _P]


def _check_shapes(table, slots, values) -> None:
    if slots.shape != values.shape:
        raise ValueError(f"slots {tuple(slots.shape)} and values "
                         f"{tuple(values.shape)} must have one shape")
    if slots.shape[:-1] != table.shape[:-1]:
        raise ValueError(f"pairs {tuple(slots.shape)} and table "
                         f"{tuple(table.shape)} must share their leading axes")


def pair_scatter_ref(table, slots, values):
    """Plain version of :func:`pair_scatter`: ``out[..., slots[..., j]] =
    values[..., j]``, pairs with a slot outside ``[0, S)`` dropped (they
    are routed to a spare column that is cut off)."""
    _check_shapes(table, slots, values)
    s = table.shape[-1]
    out = torch.cat([table.to(torch.int32),
                     table.new_zeros(table.shape[:-1] + (1,), dtype=torch.int32)], dim=-1)
    idx = torch.where((slots >= 0) & (slots < s), slots, s).to(torch.int64)
    out.scatter_(-1, idx, values.to(torch.int32))
    return out[..., :s].contiguous()


def pair_scatter(
    table: torch.Tensor,     # (..., S) int32 slot tables
    slots: torch.Tensor,     # (..., C) int32 slot ids; outside [0, S) = dropped pad
    values: torch.Tensor,    # (..., C) int32 paired values
) -> torch.Tensor:
    """Return a new ``table`` with ``table[..., slots[..., j]] =
    values[..., j]`` applied row by row.

    Pairs whose slot lies outside ``[0, S)`` are dropped (the padding
    convention of ``repro_torch.core.exchange.pack_pairs``: pad slot
    ``S``).  The real slots of one row must be unique, so the result does
    not depend on the order of the stores.
    """
    if on_cpu(table, slots, values):
        return pair_scatter_ref(table, slots, values)
    out = launch_kernel(load("pair_scatter"), table, slots, values)
    if slots.numel():
        pair_scatter.launches += 1
    return out


def launch_kernel(lib, table, slots, values) -> torch.Tensor:
    """One call of ``lib``'s C entry on CUDA tensors, as :func:`pair_scatter`
    makes it; counts no launch.  ``lib`` is the loaded library of
    ``csrc/pair_scatter.cu`` (``chip_smoke.py`` also passes the build of
    another version of that source, to time the two).  No pairs: the table
    is copied and no kernel runs."""
    _check_shapes(table, slots, values)
    s, c = table.shape[-1], slots.shape[-1]
    tab2 = table.reshape(-1, s)
    r = tab2.shape[0]
    sl2, va2 = slots.reshape(r, c), values.reshape(r, c)
    tps = check_tensor(tab2, "table", torch.int32, (r, s))
    tps = tps if r > 1 else s          # one row: its stride is never stepped
    check_tensor(sl2, "slots", torch.int32, (r, c), contiguous=True)
    check_tensor(va2, "values", torch.int32, (r, c), contiguous=True)
    out = torch.empty((r, s), dtype=torch.int32, device=table.device)
    fn = lib.pair_scatter_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(tab2.data_ptr(), tps, sl2.data_ptr(), va2.data_ptr(), out.data_ptr(),
             r, s, c, torch.cuda.current_stream(table.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pair_scatter: kernel launch failed with CUDA error {err}")
    return out.view(table.shape)


pair_scatter.launches = 0
