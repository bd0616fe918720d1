"""``collision`` — the Alg-4 speculative-collision test of the local fixed points.

``repro`` runs this test in ``jnp`` between its assignment launches
(``repro/kernels/ops.py::local_color_d1_pallas`` and
``local_color_d2_pallas``), so it has no TPU kernel; the CUDA kernel
(``csrc/collision.cu``) computes
``core/local.py::collision_losers`` restricted to a list of rows, and
commits the verdict into the color table.  One kernel, two kinds of
launch, each counted:

* :func:`collision_lists` — the first launch of a fixed point: lists the
  active rows (the rows every later launch tests; ``active`` does not
  change inside a fixed point) and, among them, the uncolored ones (the
  rows the first assignment colors), with a count per part;
* :func:`collision` — one launch per iteration: every listed row of a
  running part whose new color loses to a lane goes back to 0 in the
  table, the others take their new color, and the rows left uncolored are
  listed, with a count per part, for the next assignment.

Rows are entries ``p * R + r`` of the stacked part axis (``R`` rows a
part).  The counts are rows of ``P + 2`` int32: the rows to color of each
part, their total, and (after :func:`collision_lists`) the active rows in
all.  Lists are filled through atomics, so their order varies from run to
run; no result depends on it.  :func:`collision_lists_ref` and
:func:`collision_ref` are the plain versions (sorted lists).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.conflict import v_loses
from repro_torch.kernels import check_tensor, on_cpu
from repro_torch.kernels.build import load

__all__ = ["collision", "collision_lists", "collision_ref", "collision_lists_ref",
           "launch_kernel"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
_ARGTYPES = ([_P, _INT, _P, _INT, _P, _P, _I64, _P, _P, _I64, _P, _I64, _P, _I64]
             + [_P] * 8 + [_INT] * 4 + [_P])


def _append(nxt, out, take, entries, parts, n_parts) -> None:
    """Lists ``entries[take]`` into ``out`` (if any) and counts them into
    ``nxt``: per part, and their total."""
    e = entries[take]
    if out is not None:
        out[:len(e)] = e.to(torch.int32)
    nxt[:n_parts] += torch.bincount(parts[take], minlength=n_parts).to(torch.int32)
    nxt[n_parts] += len(e)


def collision_lists_ref(active, color_tab, rows_out, todo, nxt, *, newc=None, base=None):
    """Plain version of :func:`collision_lists`."""
    p, r = active.shape
    act = active.to(torch.bool).reshape(-1)
    entries = torch.arange(p * r, device=active.device)
    parts = entries // r
    colors = color_tab[:, :r].reshape(-1)
    _append(nxt, todo, act & (colors == 0), entries, parts, p)
    rows_out[:int(act.sum())] = entries[act].to(torch.int32)
    nxt[p + 1] += int(act.sum())
    if newc is not None:
        newc.copy_(color_tab[:, :r])
    if base is not None:
        base.view(-1)[act] = 1


def collision_lists(
    active: torch.Tensor,         # (P, R) bool
    color_tab: torch.Tensor,      # (P, T) int32, T >= R: the rows' colors first
    rows_out: torch.Tensor,       # (P*R,) int32 out: the active rows
    todo: torch.Tensor | None,    # (P*R,) int32 out: the active uncolored rows
    nxt: torch.Tensor,            # (P+2,) int32, zeroed: the counts
    *,
    newc: torch.Tensor | None = None,   # (P, R) int32 out: the rows' colors
    base: torch.Tensor | None = None,   # (P, R) int32 out: 1 at active rows
) -> None:
    """List the active rows into ``rows_out`` and the active uncolored ones
    into ``todo`` (if given); count the latter per part into ``nxt[:P]``,
    their total into ``nxt[P]`` and the active rows into ``nxt[P+1]``."""
    tensors = [t for t in (active, color_tab, rows_out, todo, nxt, newc, base)
               if t is not None]
    if on_cpu(*tensors):
        return collision_lists_ref(active, color_tab, rows_out, todo, nxt,
                                   newc=newc, base=base)
    p, r = active.shape
    t = color_tab.shape[-1]
    aps = check_tensor(active, "active", torch.bool, (p, r))
    tps = check_tensor(color_tab, "color_tab", torch.int32, (p, t))
    check_tensor(rows_out, "rows_out", torch.int32, (p * r,), contiguous=True)
    if todo is not None:
        check_tensor(todo, "todo", torch.int32, (p * r,), contiguous=True)
    check_tensor(nxt, "nxt", torch.int32, (p + 2,), contiguous=True)
    for name, x in (("newc", newc), ("base", base)):
        if x is not None:
            check_tensor(x, name, torch.int32, (p, r), contiguous=True)
    if r > t:
        raise ValueError(f"color_tab: {t} entries cannot hold {r} rows")
    _launch(load("collision"), None, 0, None, 0, None, color_tab, tps, None, None, 0, active,
            aps, None, 0, None, nxt, None, rows_out, todo, newc, base, None, p, r, True)
    if p * r > 0:
        collision.launches += 1


def _lose_rows(lanes, newc, table, deg_tab, gid_tab, e, parts, r, *, recolor_degrees):
    """``collision_losers`` of the rows ``e`` (of parts ``parts``) alone."""
    p = lanes.shape[0]
    lanes = lanes.reshape(p * r, -1)[e].to(torch.int64)            # (L, K)
    pc = parts[:, None]
    return v_loses(
        newc.reshape(-1)[e][:, None], table[pc, lanes],
        deg_tab[parts, e - parts * r][:, None], deg_tab[pc, lanes],
        gid_tab[parts, e - parts * r][:, None], gid_tab[pc, lanes],
        recolor_degrees=recolor_degrees,
    ).any(dim=-1)


def collision_ref(lanes_a, lanes_b, newc, color_tab, deg_tab, gid_tab, rows, cur, nxt,
                  spare, todo, lose, *, recolor_degrees=True):
    """Plain version of :func:`collision`: ``core/local.py::collision_losers``
    restricted to the listed rows of running parts, then their commit."""
    p, r = newc.shape
    e = rows.to(torch.int64)
    parts = e // r
    running = cur[parts] > 0
    table = color_tab.clone()
    table[:, :r] = newc
    kw = dict(recolor_degrees=recolor_degrees)
    lost = _lose_rows(lanes_a, newc, table, deg_tab, gid_tab, e, parts, r, **kw)
    if lanes_b is not None:
        lost |= _lose_rows(lanes_b, newc, table, deg_tab, gid_tab, e, parts, r, **kw)
    lost &= running
    c = torch.where(lost, 0, newc.reshape(-1)[e])
    color_tab[parts[running], (e - parts * r)[running]] = c[running]
    lose.copy_(lost)
    spare.zero_()
    _append(nxt, todo, running & (c == 0), e, parts, p)


def collision(
    lanes_a: torch.Tensor,        # (P, R, Ka) int32, contiguous: tested first
    lanes_b: torch.Tensor | None,  # (P, R, Kb) int32, contiguous, or None
    newc: torch.Tensor,           # (P, R) int32, contiguous: the rows' new colors
    color_tab: torch.Tensor,      # (P, T) int32: updated in place at tested rows
    deg_tab: torch.Tensor,        # (P, T) int32
    gid_tab: torch.Tensor,        # (P, T) int32, deg_tab's part stride
    rows: torch.Tensor,           # (L,) int32 entries p * R + r, each once
    cur: torch.Tensor,            # (P+2,) int32: this iteration's counts
    nxt: torch.Tensor,            # (P+2,) int32, zeroed: the next iteration's
    spare: torch.Tensor,          # (P+2,) int32: zeroed here
    todo: torch.Tensor | None,    # (P*R,) int32 out: the rows left to color
    lose: torch.Tensor,           # (L,) bool out: the verdict of each entry
    *,
    recolor_degrees: bool = True,
) -> None:
    """Test every listed row of a running part (``cur[p] > 0``): it loses
    when a lane of ``lanes_a`` or ``lanes_b`` holds its new color, has
    another gid and wins Algorithm 4, a lane's color being ``newc`` for
    rows and ``color_tab`` beyond them.  A loser goes back to 0 in
    ``color_tab``, every other tested row takes its new color; rows left at
    0 go into ``todo`` (if given) and ``nxt``'s counts.  Rows of stopped
    parts are left alone.  Every lane must lie in ``[0, T)``.
    """
    tensors = [t for t in (lanes_a, lanes_b, newc, color_tab, deg_tab, gid_tab, rows,
                           cur, nxt, spare, todo, lose) if t is not None]
    if on_cpu(*tensors):
        return collision_ref(lanes_a, lanes_b, newc, color_tab, deg_tab, gid_tab, rows,
                             cur, nxt, spare, todo, lose, recolor_degrees=recolor_degrees)
    launch_kernel(load("collision"), lanes_a, lanes_b, newc, color_tab, deg_tab, gid_tab,
                  rows, cur, nxt, spare, todo, lose, recolor_degrees=recolor_degrees)
    collision.launches += 1


def launch_kernel(lib, lanes_a, lanes_b, newc, color_tab, deg_tab, gid_tab, rows, cur, nxt,
                  spare, todo, lose, *, recolor_degrees=True) -> None:
    """One testing launch of ``lib``'s ``collision_launch`` on CUDA tensors,
    as :func:`collision` makes it; counts no launch.  ``lib`` is the loaded
    library of ``csrc/collision.cu`` (``chip_smoke.py`` also passes the
    build of another version of that source, to time the two)."""
    p, r, ka = lanes_a.shape
    t = color_tab.shape[-1]
    check_tensor(lanes_a, "lanes_a", torch.int32, (p, r, ka), contiguous=True)
    kb = 0
    if lanes_b is not None:
        kb = lanes_b.shape[-1]
        check_tensor(lanes_b, "lanes_b", torch.int32, (p, r, kb), contiguous=True)
    check_tensor(newc, "newc", torch.int32, (p, r), contiguous=True)
    tps = check_tensor(color_tab, "color_tab", torch.int32, (p, t))
    dps = check_tensor(deg_tab, "deg_tab", torch.int32, (p, t))
    if check_tensor(gid_tab, "gid_tab", torch.int32, (p, t)) != dps:
        raise ValueError("gid_tab: must share deg_tab's part stride")
    n = rows.shape[0]
    check_tensor(rows, "rows", torch.int32, (n,), contiguous=True)
    for name, x in (("cur", cur), ("nxt", nxt), ("spare", spare)):
        check_tensor(x, name, torch.int32, (p + 2,), contiguous=True)
    if todo is not None:
        check_tensor(todo, "todo", torch.int32, (p * r,), contiguous=True)
    check_tensor(lose, "lose", torch.bool, (n,), contiguous=True)
    if r > t:
        raise ValueError(f"color_tab: {t} entries cannot hold {r} rows")
    _launch(lib, lanes_a, ka, lanes_b, kb, newc, color_tab, tps, deg_tab, gid_tab, dps,
            None, 0, rows, n, cur, nxt, spare, None, todo, None, None, lose, p, r,
            recolor_degrees)


def _launch(lib, lanes_a, ka, lanes_b, kb, newc, tab, tps, deg, gid, dps, active, aps,
            rows, n_list, cur, nxt, spare, rows_out, todo, newc_out, base_out, lose,
            p, r, recolor_degrees) -> None:
    """One launch of ``lib.collision_launch`` (``rows`` None: a listing
    launch; an empty list has a null pointer, so the kind is passed on its
    own).  A testing launch always runs (it zeroes ``spare``); a listing
    launch over no rows launches nothing."""
    def ptr(x):
        return None if x is None else x.data_ptr()

    fn = lib.collision_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(ptr(lanes_a), ka, ptr(lanes_b), kb, ptr(newc), ptr(tab), tps, ptr(deg),
             ptr(gid), dps, ptr(active), aps, ptr(rows), n_list, ptr(cur), ptr(nxt),
             ptr(spare), ptr(rows_out), ptr(todo), ptr(newc_out), ptr(base_out),
             ptr(lose), int(rows is None), p, r, int(recolor_degrees),
             torch.cuda.current_stream(tab.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"collision: kernel launch failed with CUDA error {err}")


collision.launches = 0
