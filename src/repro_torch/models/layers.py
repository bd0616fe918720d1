"""Transformer building blocks: norms, RoPE, GQA attention, gated MLP.

The counterpart of ``repro/models/layers.py`` in PyTorch, in the
formulation ``repro`` runs by default: the ``(hkv, group)`` reshape of the
queries (``GQA_REPEAT = False``) and fp32 scores (``SCORES_FP32 = True``).
Every cast of ``repro`` is mirrored so that bf16 rounds where it does
there: scores are products of the inputs accumulated in fp32, the softmax
is fp32, probabilities are cast to v's dtype before the second product,
``rms_norm`` casts back to x's dtype before its scale and ``rope`` computes
in fp32 and casts.

Attention has three execution shapes:
  * dense   -- materialized scores (short sequences);
  * chunked -- outer loop over Q chunks, inner online softmax over KV
    chunks with fp32 accumulators (long prefill);
  * decode  -- single query against a cache.

Parameters are plain dicts of tensors with ``repro``'s tree paths and
layouts: stacked leading layer axis, ``(d_in, d_out)`` weights used as
``x @ W``.  ``repro``'s ``shard_activation`` calls are the identity on one
card and are left out.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding; x: (..., L, H, dh), positions: (..., L)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs                  # (..., L, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _mask_bias(q_pos, k_pos, *, causal: bool, window: int) -> torch.Tensor:
    """(Lq, Lk) additive fp32 mask bias."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _gqa_scores(q, k):
    """q: (B, Lq, Hq, dh), k: (B, Lk, Hkv, dh) -> (B, Hq, Lq, Lk) fp32.

    The inputs are cast to fp32 before the product: a product of two bf16
    values is exact in fp32, so this is ``repro``'s fp32-accumulated
    product of the bf16 inputs (``preferred_element_type=float32``).
    """
    b, lq, hq, dh = q.shape
    hkv = k.shape[2]
    q = q.reshape(b, lq, hkv, hq // hkv, dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", q, k.float())
    return s.reshape(b, hq, lq, k.shape[1]) * (dh ** -0.5)


def _gqa_out(p, v):
    """p: (B, Hq, Lq, Lk) fp32, v: (B, Lk, Hkv, dh) -> (B, Lq, Hq, dh) in v's dtype."""
    b, hq, lq, lk = p.shape
    hkv = v.shape[2]
    p = p.reshape(b, hkv, hq // hkv, lq, lk)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    return o.reshape(b, lq, hq, v.shape[3])


def attention_dense(q, k, v, q_pos, k_pos, *, causal: bool, window: int = 0):
    s = _gqa_scores(q, k) + _mask_bias(q_pos, k_pos, causal=causal, window=window)
    return _gqa_out(torch.softmax(s, dim=-1), v)


def attention_chunked(q, k, v, q_pos, k_pos, *, causal: bool, window: int = 0,
                      q_chunk: int = 4096, k_chunk: int = 1024):
    """Flash-style attention: outer loop over Q chunks, inner online-softmax
    loop over KV chunks.  Exact (fp32 accumulators)."""
    b, lq, hq, dh = q.shape
    lk = k.shape[1]
    q_chunk = min(q_chunk, lq)
    k_chunk = min(k_chunk, lk)
    if lq % q_chunk or lk % k_chunk:
        raise ValueError("pad sequence to chunk size")
    outs = []
    for qs in range(0, lq, q_chunk):
        qi, qpi = q[:, qs:qs + q_chunk], q_pos[qs:qs + q_chunk]
        m = torch.full((b, hq, q_chunk), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, hq, q_chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hq, q_chunk, dh), dtype=torch.float32, device=q.device)
        for ks in range(0, lk, k_chunk):
            ki, vi = k[:, ks:ks + k_chunk], v[:, ks:ks + k_chunk]
            s = _gqa_scores(qi, ki) + _mask_bias(qpi, k_pos[ks:ks + k_chunk],
                                                 causal=causal, window=window)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + _gqa_out(p, vi).float().transpose(1, 2)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2).to(q.dtype))            # (B, qc, Hq, dh)
    return torch.cat(outs, dim=1)


def attention_decode(q, k_cache, v_cache, length, *, window: int = 0):
    """q: (B, 1, Hq, dh) vs cache (B, S, Hkv, dh).

    The current token's k/v must already be written at ``length - 1``;
    positions ``< length`` are attended (minus the sliding window).
    ``length`` may be a tensor on the device: nothing here reads it on the
    host.
    """
    s = _gqa_scores(q, k_cache)                        # (B, Hq, 1, S)
    k_pos = torch.arange(k_cache.shape[1], device=q.device)
    ok = k_pos < length
    if window:
        ok &= k_pos > length - 1 - window
    s = s + torch.where(ok, 0.0, NEG_INF)[None, None, None]
    return _gqa_out(torch.softmax(s, dim=-1), v_cache)


# ---------------------------------------------------------------------------
# Parameterized modules (init + apply as plain functions over dicts).
# ---------------------------------------------------------------------------

def _normal(gen, shape, dtype, scale):
    """``scale`` times standard normal draws from ``gen`` on its device,
    drawn in fp32 and cast, so one seed gives one model in every dtype."""
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def init_attn(gen: torch.Generator, cfg, *, layers: int, dtype: torch.dtype) -> Params:
    d, dh, hq, hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    scale = d ** -0.5
    dev = gen.device
    p = {
        "wq": _normal(gen, (layers, d, hq * dh), dtype, scale),
        "wk": _normal(gen, (layers, d, hkv * dh), dtype, scale),
        "wv": _normal(gen, (layers, d, hkv * dh), dtype, scale),
        "wo": _normal(gen, (layers, hq * dh, d), dtype, scale),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((layers, hq * dh), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((layers, hkv * dh), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((layers, hkv * dh), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((layers, dh), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((layers, dh), dtype=dtype, device=dev)
    return p


def qkv_project(p, x, cfg, positions, *, rope_on: bool = True):
    """x: (B, L, D) -> q (B,L,Hq,dh), k/v (B,L,Hkv,dh) with RoPE + qk-norm."""
    b, l, _ = x.shape
    dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, l, hq, dh)
    k = k.reshape(b, l, hkv, dh)
    v = v.reshape(b, l, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope_on:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def init_mlp(gen: torch.Generator, cfg, *, layers: int, dtype: torch.dtype) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi": _normal(gen, (layers, d, f), dtype, d ** -0.5)}
    if cfg.act == "swiglu":
        p["wg"] = _normal(gen, (layers, d, f), dtype, d ** -0.5)
    p["wo"] = _normal(gen, (layers, f, d), dtype, f ** -0.5)
    return p


def mlp_apply(p, x, cfg):
    h = x @ p["wi"]
    if cfg.act == "swiglu":
        h = F.silu(x @ p["wg"]) * h
    else:
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    return h @ p["wo"]
