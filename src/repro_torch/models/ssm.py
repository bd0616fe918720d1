"""Mamba-2 (SSD, state-space duality) block: chunked scan and recurrent decode.

The counterpart of ``repro/models/ssm.py``.  Per head h a scalar decay
``a_t = exp(dt_t * A_h)``; a state ``S`` of shape (P, N) updated as
``S_t = a_t S_{t-1} + dt_t x_t B_t^T``; output ``y_t = C_t S_t + D x_t``.

The full-sequence form is ``repro``'s chunked dual form: a quadratic
attention-like term within each chunk, then the state recurrence across
chunks (``repro``'s ``lax.scan`` over chunks is a Python loop here).
Decode keeps ``(conv, s)`` and is O(1) a token.

Dtypes follow ``repro`` cast for cast: the projections, convolutions and
products run in the model's dtype, the step sizes, decays and the carried
state in float32 (``a_log``, ``d_skip`` and ``dt_bias`` are float32
parameters), and each float32 factor is cast to the model's dtype where
``repro`` casts it, just before its product.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, _normal, rms_norm
from repro_torch.launch.mesh import axis_names
from repro_torch.models.sharding import (
    batch_placements,
    batch_split,
    even_split,
    keep_grad_split,
    replicated,
    split_columns,
)


def init_ssm(gen: torch.Generator, cfg, *, layers: int, dtype: torch.dtype) -> Params:
    """``repro``'s ``init_ssm`` tree: the same paths, shapes, scales and
    dtypes (the three per-head scalars in float32)."""
    d, di, n, h = cfg.d_model, cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    dev = gen.device

    def const(value, shape, dt):
        return torch.full(shape, value, dtype=dt, device=dev)

    return {
        "in_xz": _normal(gen, (layers, d, 2 * di), dtype, d ** -0.5),
        "in_b": _normal(gen, (layers, d, n), dtype, d ** -0.5),
        "in_c": _normal(gen, (layers, d, n), dtype, d ** -0.5),
        "in_dt": _normal(gen, (layers, d, h), dtype, d ** -0.5),
        "conv_x": _normal(gen, (layers, cfg.ssm_conv, di), dtype, 0.1),
        "conv_b": _normal(gen, (layers, cfg.ssm_conv, n), dtype, 0.1),
        "conv_c": _normal(gen, (layers, cfg.ssm_conv, n), dtype, 0.1),
        "a_log": const(0.0, (layers, h), torch.float32),
        "d_skip": const(1.0, (layers, h), torch.float32),
        "dt_bias": const(0.0, (layers, h), torch.float32),
        "norm": const(1.0, (layers, di), dtype),
        "out": _normal(gen, (layers, di, d), dtype, di ** -0.5),
    }


def _causal_conv(x, w):
    """x: (B, L, C), w: (K, C): depthwise causal conv, then SiLU.  The K - 1
    leading zeros are joined on with ``cat``: torch 2.11's DTensor fails to
    plan the redistribution of ``F.pad``'s input on a mesh."""
    k = w.shape[0]
    xp = torch.cat([torch.zeros_like(x[:, :1])] * (k - 1) + [x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return F.silu(out)


def _step_sizes(p, x):
    """(dt, dt * A): float32 (B, L, H) step sizes and log-decays."""
    dt = F.softplus((x @ p["in_dt"]).float() + p["dt_bias"])
    return dt, dt * -torch.exp(p["a_log"])


def ssm_apply(p, x, cfg):
    """Chunked SSD forward. x: (B, L, D) -> (B, L, D)."""
    l_in = x.shape[1]
    q = min(cfg.ssm_chunk, l_in)
    if l_in % q:
        # End-pad to a chunk multiple (causal: pads never affect real rows).
        x = F.pad(x, (0, 0, 0, q - l_in % q))
        return ssm_apply(p, x, cfg)[:, :l_in]
    di, hd = cfg.ssm_inner, cfg.ssm_head_dim

    xs, z = (keep_grad_split(x @ w, 2) for w in split_columns(p["in_xz"], di))  # (B, L, di)
    bs = _causal_conv(x @ p["in_b"], p["conv_b"])            # (B, L, N)
    cs = _causal_conv(x @ p["in_c"], p["conv_c"])            # (B, L, N)
    xs = _causal_conv(xs, p["conv_x"])                       # (B, L, di)
    dt, dta = _step_sizes(p, x)                              # (B, L, H) fp32

    y = _ssd_on_mesh(xs, bs, cs, dt, dta, p["d_skip"], q, hd,
                     shard_heads=cfg.shard_ssm_heads)          # (B, L, di)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out"]


def _ssd(xs, bs, cs, dt, dta, d_skip, q: int, hd: int):
    """The chunked dual form over ``xs`` (B, L, H·hd), ``bs``, ``cs`` (B, L,
    N), ``dt``, ``dta`` (B, L, H) and ``d_skip`` (H,), with the skip term:
    (B, L, H·hd)."""
    xh, cc, cums, y_diag, chunk_decay, state_c = _ssd_chunks(xs, bs, cs, dt, dta, q, hd)
    return _ssd_out(xh, cc, cums, y_diag, _ssd_states(chunk_decay, state_c), d_skip)


def _ssd_chunks(xs, bs, cs, dt, dta, q: int, hd: int):
    """What each chunk gives on its own: (xh (B, nc, Q, H, hd), cc (B, nc, Q,
    N), cums (B, nc, Q, H), the within-chunk term y_diag (B, nc, Q, H, hd),
    each chunk's total decay (B, nc, H) and its state (B, nc, H, hd, N))."""
    b, l, h = dt.shape
    n, nc = bs.shape[2], l // q

    # Chunk views.
    xh = xs.reshape(b, nc, q, h, hd)
    bc = bs.reshape(b, nc, q, n)
    cc = cs.reshape(b, nc, q, n)
    dtc = dt.reshape(b, nc, q, h)
    cums = torch.cumsum(dta.reshape(b, nc, q, h), dim=2)     # (B, nc, Q, H)

    # Within-chunk (diagonal) term: quadratic, attention-like.
    seg = cums[:, :, :, None, :] - cums[:, :, None, :, :]    # (B,nc,Q,Q,H) log decay i>=j
    li = torch.arange(q, device=xs.device)
    causal = (li[:, None] >= li[None, :])[None, None, :, :, None]
    # Masked before the exp, so the same decays as repro's where(causal,
    # exp(seg), 0): above the diagonal seg is positive, and at the published
    # width its exp overflows, whose gradient (0 times inf) is NaN.
    decay = torch.exp(torch.where(causal, seg, -math.inf))   # (B,nc,Q,Q,H)
    del seg
    scores = torch.einsum("bcqn,bcsn->bcqs", cc, bc)         # (B,nc,Q,Q)
    w = scores[..., None] * decay * dtc[:, :, None, :, :]    # (B,nc,Q,S,H) fp32
    del decay
    y_diag = torch.einsum("bcqsh,bcshp->bcqhp", w.to(xh.dtype), xh)
    del w

    chunk_decay = torch.exp(cums[:, :, -1])                  # (B, nc, H) total decay
    # Each chunk's state: sum_s exp(cum_last - cum_s) dt_s x_s B_s^T.
    rdec = torch.exp(cums[:, :, -1:, :] - cums) * dtc        # (B,nc,Q,H)
    state_c = torch.einsum("bcqh,bcqhp,bcqn->bchpn", rdec.to(xh.dtype), xh, bc)
    return xh, cc, cums, y_diag, chunk_decay, state_c


def _ssd_states(chunk_decay, state_c):
    """The cross-chunk recurrence: the float32 state at each chunk's start
    (B, nc, H, hd, N), from each chunk's total decay and state."""
    b, nc, h, hd, n = state_c.shape
    s = torch.zeros((b, h, hd, n), dtype=torch.float32, device=state_c.device)
    s_before = []
    for c in range(nc):
        s_before.append(s)
        s = s * chunk_decay[:, c, :, None, None] + state_c[:, c].float()
    return torch.stack(s_before, dim=1)


def _ssd_out(xh, cc, cums, y_diag, s_before, d_skip):
    """(B, L, H·hd): the within-chunk term, the off-diagonal term
    ``y_off[t] = exp(cum_t) * C_t . S_chunk_start`` and the skip term."""
    b, nc, q, h, hd = xh.shape
    into = torch.exp(cums)                                   # (B,nc,Q,H)
    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", cc, s_before.to(cc.dtype),
                         into.to(cc.dtype))

    y = (y_diag + y_off).reshape(b, nc * q, h, hd)
    y = y + xh.reshape(b, nc * q, h, hd) * d_skip.to(y.dtype).reshape(1, 1, h, 1)
    return y.reshape(b, nc * q, h * hd)


def _local(t, mesh, place, grad):
    """The rank's shard of ``t`` (a DTensor, or a plain tensor every rank
    holds whole) placed by ``place``, as a plain tensor whose gradient is
    placed by ``grad``."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return t.redistribute(mesh, place).to_local(grad_placements=grad)


def _placed(y, mesh, place, shape):
    """The rank's plain result ``y`` as its part of a DTensor of the global
    ``shape``, placed by ``place``."""
    from torch.distributed.tensor import DTensor

    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(y.contiguous(), mesh, place, run_check=False,
                              shape=tuple(shape), stride=stride)


def _ssd_on_mesh(xs, bs, cs, dt, dta, d_skip, q: int, hd: int, *, shard_heads: bool):
    """:func:`_ssd`; on a mesh, each rank runs its share on plain local
    shards, the batch split as ``xs``'s:

    * by heads, as ``repro``'s partitioner keeps the SSM heads on
      ``model``, where ``shard_heads`` (the config's ``shard_ssm_heads``)
      and the heads divide ``model``: ``xs``, ``dt``, ``dta`` and
      ``d_skip`` split by heads there, ``bs`` and ``cs`` whole (their
      gradient a partial sum over ``model``, ``d_skip``'s over the batch's
      axes); the result stays split by heads;
    * else by chunks, where the chunks divide ``model``
      (:func:`_ssd_by_chunks`); the result, split on the sequence over
      ``model``, is gathered there, as the fallback's;
    * else (the chunks do not divide ``model`` either, or the batch is
      already split on it) every rank runs it on DTensors with only the
      batch split: every ``model`` rank does the same work."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(xs, DTensor):
        return _ssd(xs, bs, cs, dt, dta, d_skip, q, hd)
    mesh = xs.device_mesh
    names = axis_names(mesh)
    base = batch_placements(xs)
    m = names.index("model") if "model" in names else None
    ntp = 1 if m is None else mesh.size(m)
    h, nc = dt.shape[2], dt.shape[1] // q
    by_heads = shard_heads and h % ntp == 0
    if ntp == 1 or base[m] != Replicate() or not by_heads and nc % ntp:
        xs, bs, cs, dt, dta = (batch_split(t) for t in (xs, bs, cs, dt, dta))
        return batch_split(_ssd(xs, bs, cs, dt, dta, replicated(d_skip), q, hd))
    if not by_heads:
        return batch_split(_ssd_by_chunks(xs, bs, cs, dt, dta, d_skip, q, hd, base, m))
    heads = list(base)
    heads[m] = Shard(2)
    shared = [Partial() if i == m else p for i, p in enumerate(base)]
    per_head = [Shard(0) if i == m else Replicate() for i in range(mesh.ndim)]
    per_head_grad = [Shard(0) if i == m else Partial() if p == Shard(0) else Replicate()
                     for i, p in enumerate(base)]
    y = _ssd(_local(xs, mesh, heads, heads), _local(bs, mesh, base, shared),
             _local(cs, mesh, base, shared), _local(dt, mesh, heads, heads),
             _local(dta, mesh, heads, heads), _local(d_skip, mesh, per_head, per_head_grad),
             q, hd)
    return _placed(y, mesh, heads, xs.shape)


def _ssd_by_chunks(xs, bs, cs, dt, dta, d_skip, q: int, hd: int, base, m: int):
    """:func:`_ssd` on DTensors placed by ``base`` (the batch split alone),
    split over the mesh axis ``m`` by chunks: each rank computes the
    within-chunk term and the states of its own chunks (every input split
    on the sequence over ``m``); the chunks' states and total decays are
    all-gathered over ``m``; every rank runs the cross-chunk recurrence
    (elementwise and cheap) and computes the off-diagonal term of its own
    chunks.  The gathered states' gradient is a partial sum over ``m`` (a
    reduce-scatter on the way back), ``d_skip``'s over ``m`` and the
    batch's axes.  Returns (B, L, H·hd) split on the sequence over ``m``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = xs.device_mesh
    seq = list(base)
    seq[m] = Shard(1)
    xh, cc, cums, y_diag, chunk_decay, state_c = _ssd_chunks(
        *(_local(t, mesh, seq, seq) for t in (xs, bs, cs, dt, dta)), q, hd)
    gathered_grad = [Partial() if i == m else p for i, p in enumerate(base)]

    def gathered(t):
        """(B_loc, nc / |m|, ...) -> (B_loc, nc, ...): every rank's chunks."""
        whole = (xs.shape[0], t.shape[1] * mesh.size(m), *t.shape[2:])
        return _placed(t, mesh, seq, whole).redistribute(mesh, base).to_local(
            grad_placements=gathered_grad)

    ncl = chunk_decay.shape[1]
    first = mesh.get_local_rank(m) * ncl
    s_before = _ssd_states(gathered(chunk_decay), gathered(state_c))[:, first:first + ncl]
    skip_grad = [Partial() if i == m or p == Shard(0) else Replicate()
                 for i, p in enumerate(base)]
    y = _ssd_out(xh, cc, cums, y_diag, s_before,
                 _local(d_skip, mesh, [Replicate()] * mesh.ndim, skip_grad))
    return _placed(y, mesh, seq, xs.shape)


def ssm_decode(p, x, state, cfg):
    """One-token recurrent step.

    x: (B, 1, D); state = {"conv": (B, K-1, di + 2N), "s": (B, H, P, N)}.
    Returns (y (B, 1, D), new state).
    """
    b = x.shape[0]
    di, n, hd, h = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_heads

    xs, z = (x @ p["in_xz"]).split(di, dim=-1)              # (B, 1, di)
    cat = torch.cat([xs, x @ p["in_b"], x @ p["in_c"]], dim=-1)   # (B, 1, di+2N)
    conv_hist = torch.cat([state["conv"], cat], dim=1)       # (B, K, C)
    wcat = torch.cat([p["conv_x"], p["conv_b"], p["conv_c"]], dim=-1)
    conv_out = F.silu((conv_hist * wcat[None]).sum(dim=1, keepdim=True))
    xs, bs, cs = conv_out.split([di, n, n], dim=-1)

    dt, dta = _step_sizes(p, x)                              # (B, 1, H)
    # On a mesh the heads stay split only where they divide.
    dt, dta = even_split(dt, 2, h), even_split(dta, 2, h)
    xh = even_split(xs, 2, h).reshape(b, h, hd)
    s_new = even_split(state["s"], 1, h) * torch.exp(dta[:, 0])[..., None, None] \
        + torch.einsum("bh,bhp,bn->bhpn", dt[:, 0].to(xh.dtype), xh, bs[:, 0]).float()
    y = torch.einsum("bn,bhpn->bhp", cs[:, 0], s_new.to(cs.dtype))
    y = y + xh * p["d_skip"][:, None].to(y.dtype)
    y = rms_norm(even_split(y, 1, h).reshape(b, 1, di) * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out"], {"conv": conv_hist[:, 1:], "s": s_new}


def ssm_prefill_state(p, h, cfg):
    """The ``(conv, s)`` state after the prompt ``h`` (the block's input,
    after its norm), in closed form: ``repro``'s ``_ssm_prefill_state``."""
    b, l, _ = h.shape
    di = cfg.ssm_inner
    xs_pre = (h @ p["in_xz"])[..., :di]
    bs_pre = h @ p["in_b"]
    # The conv state: the last K-1 inputs before the convolution.
    cat = torch.cat([xs_pre, bs_pre, h @ p["in_c"]], dim=-1)
    conv_state = cat[:, -(cfg.ssm_conv - 1):]
    xs = _causal_conv(xs_pre, p["conv_x"])
    bs = _causal_conv(bs_pre, p["conv_b"])
    dt, dta = _step_sizes(p, h)
    # s = sum_t exp(sum_{t'>t} dta_t') dt_t x_t B_t^T
    tail = torch.flip(torch.cumsum(torch.flip(dta, [1]), dim=1), [1])  # incl. self
    w = torch.exp(tail - dta) * dt                           # decay after t
    xh = xs.reshape(b, l, cfg.ssm_heads, cfg.ssm_head_dim)
    s = torch.einsum("blh,blhp,bln->bhpn", w.to(xh.dtype), xh, bs)
    return {"conv": conv_state, "s": s.float()}


def init_ssm_state(cfg, batch: int, *, device) -> dict:
    di, n = cfg.ssm_inner, cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * n),
                            dtype=getattr(torch, cfg.dtype), device=device),
        "s": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                         dtype=torch.float32, device=device),
    }
