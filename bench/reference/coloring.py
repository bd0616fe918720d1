"""Plain reference of the distributed speculate-and-iterate coloring.

The paper's Algorithm 2 over a block partition into slabs, written over
the global vertex ids in plain PyTorch (any device), independent of the
program: no partitioned tables, ghost layers or send buffers are built.
A part's view of a vertex is worked out from the partition alone: a vertex
of the same part is read as it is now, a vertex of another part as it was
at the last exchange (its ghost), and a padding lane as color 0.

One request, from ``colors0`` (zeros when cold) and the ``active`` set:

1. every part colors its active vertices to its own fixed point, the
   ghosts read from ``colors0``;
2. exchange: every ghost takes its owner's color;
3. round: every boundary vertex tests its ghost lanes (Algorithm 4: equal
   nonzero colors conflict; the lower degree loses, then the higher hash of
   the global id, then the higher id), the losers are uncolored and their
   parts color them to a fixed point against the exchanged ghosts;
4. 2-3 repeat while the round found a conflict, at most ``max_rounds``
   times after the first.

The fixed point (VB_BIT): every uncolored active vertex takes the lowest
color of its window ``[base, base + 32)`` that no lane holds (a full
window moves the base up by 32); then every active vertex of a running
part that shares its new color with a lane and loses the pair is
uncolored.  A part runs while it has an uncolored active vertex.

Distance-1 lanes are the neighbours; distance-2 lanes are the neighbours
and then every neighbour's neighbours, the vertex itself and repeats
included (a two-hop vertex reached twice is counted twice in the
conflict count).

The exchange's payload is that of ``sparse_delta``: per exchange, one
count word for every ordered pair of parts with traffic, and a
``(slot, color)`` pair of int32 words for every vertex whose color changed
since the last exchange, once for every other part that holds it as a
ghost (every part within one hop, or two with a second ghost layer),
divided by the part count.

Each pass (the first coloring, then every round) records the rows it
colored and the rows it checked, from which ``work.py`` counts the bytes
the algorithm needs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
WINDOW = 32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` below ``2**32``, in 16-bit halves
    so that no product leaves int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & MASK32


def gid_hash(gid: torch.Tensor) -> torch.Tensor:
    """The tie-break hash of a global id (lowbias32), as int64 below 2**32."""
    x = gid.to(torch.int64) & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


@dataclasses.dataclass
class Pass:
    """What one pass touched: ``colored`` and ``checked`` rows, (n,) bool."""
    colored: torch.Tensor
    checked: torch.Tensor


@dataclasses.dataclass
class Result:
    colors: np.ndarray          # (n,) int32
    rounds: int
    converged: bool
    total_conflicts: int
    bytes_by_round: np.ndarray  # (rounds + 1,) int64
    passes: list

    @property
    def n_colors(self) -> int:
        c = self.colors[self.colors > 0]
        return int(np.unique(c).size)


def _blocks(rows: torch.Tensor, size: int = 1 << 22):
    """``rows`` in blocks, so that a block's lanes fit beside the tables."""
    return [rows[i:i + size] for i in range(0, rows.numel(), size)] or [rows]


class Topology:
    """The graph, its block partition and everything derived from them.

    ``ell`` is ``(n, W)`` int neighbour lanes, ``-1`` past a degree.
    ``problem`` is ``"d1"`` or ``"d2"``; ``second_layer`` says whether the
    parts hold a second ghost layer (it sets who receives a color).
    """

    def __init__(self, ell, n_parts: int, problem: str, *, second_layer: bool,
                 recolor_degrees: bool = True, device="cpu"):
        if problem not in ("d1", "d2"):
            raise ValueError(f"problem must be d1 or d2, got {problem!r}")
        if n_parts > 62:
            raise ValueError("at most 62 parts (a part set is an int64 bitmask)")
        self.device = torch.device(device)
        one_hop = torch.as_tensor(np.asarray(ell), device=self.device).to(torch.int64)
        n, w = one_hop.shape
        self.n, self.w, self.n_parts, self.problem = n, w, n_parts, problem
        self.recolor_degrees = recolor_degrees
        pad = n                                   # lanes past a degree point here
        one_hop = torch.where(one_hop < 0, pad, one_hop)
        self.one_hop = one_hop
        ext = torch.cat([one_hop, torch.full((1, w), pad, device=self.device)])
        if problem == "d2":
            two_hop = ext[one_hop].reshape(n, w * w)
            self.lanes = torch.cat([one_hop, two_hop], dim=1)
        else:
            self.lanes = one_hop
        ids = torch.arange(n + 1, device=self.device)
        bounds = torch.as_tensor(np.linspace(0, n, n_parts + 1).astype(np.int64),
                                 device=self.device)
        part = torch.bucketize(ids, bounds[1:-1], right=True)
        part[n] = n_parts                         # the pad is nobody's
        self.part = part
        self.deg = torch.cat([(one_hop < pad).sum(dim=1),
                              torch.zeros(1, dtype=torch.int64, device=self.device)])
        self.hash = gid_hash(ids)
        self.gid = ids
        self.boundary = torch.cat([self._cross(r, self.lanes[r]).any(dim=1)
                                   for r in _blocks(torch.arange(n, device=self.device))])
        self._exchange_tables(second_layer)

    def _cross(self, rows, lanes):
        """Lanes that hold a vertex of another part (no pad)."""
        return (lanes < self.n) & (self.part[lanes] != self.part[rows][:, None])

    def _exchange_tables(self, second_layer: bool) -> None:
        """``receivers[v]``: how many other parts hold ``v`` as a ghost;
        ``headers``: ordered pairs of parts with traffic."""
        n, p = self.n, self.n_parts
        reach = self.one_hop
        if second_layer:
            ext = torch.cat([self.one_hop,
                             torch.full((1, self.w), n, device=self.device)])
            reach = torch.cat([reach, ext[self.one_hop].reshape(n, -1)], dim=1)
        # Part v is within reach of: the parts of the vertices within reach.
        bit = torch.ones(1, dtype=torch.int64, device=self.device)
        sets = torch.zeros(n, dtype=torch.int64, device=self.device)
        for k in range(reach.shape[1]):
            q = self.part[reach[:, k]]
            sets |= torch.where(q < p, bit << q, 0)
        own = bit << self.part[:n]
        sets &= ~own
        self.receivers = sum(((sets >> q) & 1) for q in range(p))
        headers = 0
        for o in range(p):
            mine = sets[self.part[:n] == o]
            headers += sum(int(((mine >> q) & 1).any()) for q in range(p))
        self.headers = headers

    # -- the algorithm -----------------------------------------------------

    def _loses(self, v, u):
        """Algorithm 4: True where ``v`` loses the pair ``(v, u)`` (colors
        not compared here)."""
        hv, hu = self.hash[v], self.hash[u]
        loses = torch.where(hv != hu, hv > hu, self.gid[v] > self.gid[u])
        if self.recolor_degrees:
            dv, du = self.deg[v], self.deg[u]
            loses = torch.where(dv != du, dv < du, loses)
        return loses

    def _seen(self, rows, lanes, now, ghosts):
        """Colors that the parts of ``rows`` read at ``lanes``."""
        same = self.part[lanes] == self.part[rows][:, None]
        return torch.where(same, now[lanes], ghosts[lanes])

    def _fixed_point(self, cur, ghosts, active, colored, max_iters: int):
        """Color every part's active vertices to its fixed point; ``cur`` and
        ``ghosts`` are ``(n + 1,)`` with the pad's 0 last."""
        act = torch.nonzero(active[: self.n]).view(-1)
        base = torch.ones(self.n, dtype=torch.int64, device=self.device)
        for _ in range(max_iters):
            todo = act[cur[act] == 0]
            if todo.numel() == 0:
                break
            running = torch.zeros(self.n_parts + 1, dtype=torch.bool, device=self.device)
            running[self.part[todo]] = True
            rows = act[running[self.part[act]]]
            colored[todo] = True
            # Assign: the lowest color of the window that no lane holds.
            new = cur.clone()
            for r in _blocks(todo):
                seen = self._seen(r, self.lanes[r], cur, ghosts)
                b = base[r]
                rel = seen - b[:, None]
                hit = (seen > 0) & (rel >= 0) & (rel < WINDOW)
                taken = torch.zeros((r.numel(), WINDOW + 1), dtype=torch.bool,
                                    device=self.device)
                taken.scatter_(1, torch.where(hit, rel, WINDOW), True)
                free = ~taken[:, :WINDOW]
                ok = free.any(dim=1)
                new[r[ok]] = (b + free.to(torch.int8).argmax(dim=1))[ok]
                base[r[~ok]] += WINDOW
            # Resolve: an active vertex that shares its color and loses.
            lost = []
            for r in _blocks(rows):
                lanes = self.lanes[r]
                seen = self._seen(r, lanes, new, ghosts)
                c = new[r][:, None]
                clash = (seen == c) & (c > 0) & (lanes != r[:, None])
                lost.append(r[(clash & self._loses(r[:, None], lanes)).any(dim=1)])
            new[torch.cat(lost)] = 0
            cur = new
        return cur

    def _exchange(self, cur, prev):
        """The payload of one exchange; the ghosts become ``cur``."""
        changed = cur[: self.n] != prev[: self.n]
        pairs = int((self.receivers * changed).sum())
        return (4 * self.headers + 8 * pairs) // self.n_parts

    def _round(self, cur, max_iters: int):
        """Detect against the freshly exchanged ghosts, uncolor the losers,
        recolor them.  Returns (colors, conflicts, pass)."""
        ghosts = cur
        rows = torch.nonzero(self.boundary).view(-1)
        conflicts, lost = 0, []
        for r in _blocks(rows):
            lanes = self.lanes[r]
            c = cur[r][:, None]
            clash = self._cross(r, lanes) & (cur[lanes] == c) & (c > 0)
            conflicts += int(clash.sum())
            lost.append(r[(clash & self._loses(r[:, None], lanes)).any(dim=1)])
        lose = torch.cat(lost)
        now = cur.clone()
        now[lose] = 0
        active = torch.zeros(self.n + 1, dtype=torch.bool, device=self.device)
        active[lose] = True
        colored = torch.zeros(self.n, dtype=torch.bool, device=self.device)
        now = self._fixed_point(now, ghosts, active, colored, max_iters)
        checked = torch.zeros(self.n, dtype=torch.bool, device=self.device)
        checked[rows] = True
        return now, conflicts, Pass(colored, checked)

    def color(self, colors0=None, active=None, *, max_rounds: int = 64,
              resolve: bool = True) -> Result:
        """One request.  ``colors0`` (n,) int initial colors (zeros when
        None), ``active`` (n,) bool the vertices to color (all when None).
        ``resolve=False`` stops after the first coloring: the parts'
        speculative colorings without the conflict rounds."""
        n, dev = self.n, self.device
        max_iters = 512 if self.problem == "d1" else 1024
        cur = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        if colors0 is not None:
            cur[:n] = torch.as_tensor(np.asarray(colors0), device=dev).to(torch.int64)
        act = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        if active is None:
            act[:n] = True
        else:
            act[:n] = torch.as_tensor(np.asarray(active, bool), device=dev)
        colored = torch.zeros(n, dtype=torch.bool, device=dev)
        cur = self._fixed_point(cur, cur.clone(), act, colored, max_iters)
        passes = [Pass(colored, torch.zeros_like(colored))]
        if not resolve:
            return Result(cur[:n].cpu().numpy().astype(np.int32), 0, False, 0,
                          np.zeros(0, np.int64), passes)
        prev = torch.zeros_like(cur)
        sent = [self._exchange(cur, prev)]
        prev = cur
        cur, conf, ps = self._round(cur, max_iters)
        passes.append(ps)
        rounds, total = 0, conf
        while conf > 0 and rounds < max_rounds:
            sent.append(self._exchange(cur, prev))
            prev = cur
            cur, conf, ps = self._round(cur, max_iters)
            passes.append(ps)
            rounds += 1
            total += conf
        return Result(cur[:n].cpu().numpy().astype(np.int32), rounds, conf == 0,
                      total, np.asarray(sent, np.int64), passes)

    def improper(self, colors) -> int:
        """Vertices left uncolored, plus ordered lane pairs of distinct
        vertices that share a color (one-hop for d1, one- and two-hop for
        d2): 0 exactly for a complete proper coloring."""
        c = torch.cat([torch.as_tensor(np.asarray(colors), device=self.device)
                       .to(torch.int64),
                       torch.zeros(1, dtype=torch.int64, device=self.device)])
        bad = int((c[: self.n] <= 0).sum())
        for r in _blocks(torch.arange(self.n, device=self.device)):
            lanes = self.lanes[r]
            bad += int(((c[lanes] == c[r][:, None]) & (lanes != r[:, None])
                        & (lanes < self.n)).sum())
        return bad
