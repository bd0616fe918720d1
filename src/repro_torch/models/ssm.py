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

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, _normal, rms_norm


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
    """x: (B, L, C), w: (K, C): depthwise causal conv, then SiLU."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
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
    b, l, _ = x.shape
    di, n, hd, h = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_heads
    nc = l // q

    xs, z = (x @ p["in_xz"]).split(di, dim=-1)              # (B, L, di)
    bs = _causal_conv(x @ p["in_b"], p["conv_b"])            # (B, L, N)
    cs = _causal_conv(x @ p["in_c"], p["conv_c"])            # (B, L, N)
    xs = _causal_conv(xs, p["conv_x"])                       # (B, L, di)
    dt, dta = _step_sizes(p, x)                              # (B, L, H) fp32

    # Chunk views.
    xh = xs.reshape(b, nc, q, h, hd)
    bc = bs.reshape(b, nc, q, n)
    cc = cs.reshape(b, nc, q, n)
    dtc = dt.reshape(b, nc, q, h)
    cums = torch.cumsum(dta.reshape(b, nc, q, h), dim=2)     # (B, nc, Q, H)

    # Within-chunk (diagonal) term: quadratic, attention-like.
    seg = cums[:, :, :, None, :] - cums[:, :, None, :, :]    # (B,nc,Q,Q,H) log decay i>=j
    li = torch.arange(q, device=x.device)
    causal = (li[:, None] >= li[None, :])[None, None, :, :, None]
    decay = torch.where(causal, torch.exp(seg), 0.0)         # (B,nc,Q,Q,H)
    del seg
    scores = torch.einsum("bcqn,bcsn->bcqs", cc, bc)         # (B,nc,Q,Q)
    w = scores[..., None] * decay * dtc[:, :, None, :, :]    # (B,nc,Q,S,H) fp32
    del decay
    y_diag = torch.einsum("bcqsh,bcshp->bcqhp", w.to(xh.dtype), xh)
    del w

    # Cross-chunk recurrence over chunk states.
    chunk_decay = torch.exp(cums[:, :, -1])                  # (B, nc, H) total decay
    # Each chunk's state: sum_s exp(cum_last - cum_s) dt_s x_s B_s^T.
    rdec = torch.exp(cums[:, :, -1:, :] - cums) * dtc        # (B,nc,Q,H)
    state_c = torch.einsum("bcqh,bcqhp,bcqn->bchpn", rdec.to(xh.dtype), xh, bc)
    s = torch.zeros((b, h, hd, n), dtype=torch.float32, device=x.device)
    s_before = []
    for c in range(nc):
        s_before.append(s)
        s = s * chunk_decay[:, c, :, None, None] + state_c[:, c].float()
    s_before = torch.stack(s_before, dim=1)                  # (B, nc, H, P, N)

    # Off-diagonal output: y_off[t] = exp(cum_t) * C_t . S_chunk_start.
    into = torch.exp(cums)                                   # (B,nc,Q,H)
    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", cc, s_before.to(cc.dtype),
                         into.to(cc.dtype))

    y = (y_diag + y_off).reshape(b, l, h, hd)
    y = y + xh.reshape(b, l, h, hd) * p["d_skip"].to(y.dtype).reshape(1, 1, h, 1)
    y = rms_norm(y.reshape(b, l, di) * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out"]


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
    xh = xs.reshape(b, h, hd)
    s_new = state["s"] * torch.exp(dta[:, 0])[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt[:, 0].to(xh.dtype), xh, bs[:, 0]).float()
    y = torch.einsum("bn,bhpn->bhp", cs[:, 0], s_new.to(cs.dtype))
    y = y + xh * p["d_skip"][:, None].to(y.dtype)
    y = rms_norm(y.reshape(b, 1, di) * F.silu(z), p["norm"], cfg.norm_eps)
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
