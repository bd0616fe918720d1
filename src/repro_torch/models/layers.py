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
``x @ W``.  ``qkv_project`` constrains q, k and v as ``repro``'s does
(``models/sharding.py``; the identity without a policy).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.sharding import (
    batch_split,
    on_local_heads,
    shard_activation,
    split_heads,
)

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
    return on_local_heads(_dense, q, k, v, q_pos, k_pos, causal=causal, window=window)


def _dense(q, k, v, q_pos, k_pos, *, causal: bool, window: int):
    s = _gqa_scores(q, k) + _mask_bias(q_pos, k_pos, causal=causal, window=window)
    return _gqa_out(torch.softmax(s, dim=-1), v)


class _AttnCore(torch.autograd.Function):
    """Dense attention with ``repro``'s bf16-operand backward
    (``repro/models/layers.py::_attn_core``, its custom VJP): the softmax
    math stays fp32, every tensor the backward pass materializes is cast to
    q's dtype, products of those accumulate in fp32.  ``attention_dense``
    does not call it: ``repro`` runs it only under its study flag
    ``ATTN_CUSTOM_VJP``, off by default, and the port fixes the default."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        p = torch.softmax(_gqa_scores(q, k) + bias, dim=-1)
        ctx.save_for_backward(q, k, v, p.to(q.dtype))
        return _gqa_out(p, v)

    @staticmethod
    def backward(ctx, do):
        q, k, v, p16 = ctx.saved_tensors
        dt, dh = q.dtype, q.shape[3]
        g = q.shape[2] // k.shape[2]
        do16 = do.to(dt)
        k_rep = torch.repeat_interleave(k, g, dim=2) if g > 1 else k
        v_rep = torch.repeat_interleave(v, g, dim=2) if g > 1 else v
        # dv (B, S, Hq, dh), then summed over each kv head's group.
        dv_full = torch.einsum("bhqs,bqhd->bshd", p16, do16)
        # fp32 accumulation of a bf16 product: the product of fp32 casts.
        dp = torch.einsum("bqhd,bshd->bhqs", do16.float(), v_rep.float())
        p32 = p16.float()
        ds = p32 * (dp - (dp * p32).sum(-1, keepdim=True))
        ds16 = (ds * (dh ** -0.5)).to(dt)
        dq = torch.einsum("bhqs,bshd->bqhd", ds16, k_rep)
        dk_full = torch.einsum("bhqs,bqhd->bshd", ds16, q)

        def fold(full):
            if g == 1:
                return full
            b, s_len = full.shape[:2]
            return full.reshape(b, s_len, k.shape[2], g, dh).sum(3)

        return dq, fold(dk_full), fold(dv_full), None


def _attn_core(q, k, v, bias):
    """``repro``'s ``_attn_core``: attention over an additive fp32 ``bias``
    (``_mask_bias``), differentiated by ``_AttnCore.backward``."""
    return _AttnCore.apply(q, k, v, bias)


def attention_chunked(q, k, v, q_pos, k_pos, *, causal: bool, window: int = 0,
                      q_chunk: int = 4096, k_chunk: int = 1024):
    """Flash-style attention: outer loop over Q chunks, inner online-softmax
    loop over KV chunks.  Exact (fp32 accumulators)."""
    return on_local_heads(_chunked, q, k, v, q_pos, k_pos, causal=causal, window=window,
                          q_chunk=q_chunk, k_chunk=k_chunk)


def _chunked(q, k, v, q_pos, k_pos, *, causal: bool, window: int, q_chunk: int,
             k_chunk: int):
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
    host.  On a mesh (a DTensor cache) see :func:`_decode_on_mesh`.
    """
    from torch.distributed.tensor import DTensor

    if isinstance(k_cache, DTensor):
        return _decode_on_mesh(q, k_cache, v_cache, length, window)
    s = _gqa_scores(q, k_cache)                        # (B, Hq, 1, S)
    s = s + _decode_bias(torch.arange(k_cache.shape[1], device=q.device), length, window)
    return _gqa_out(torch.softmax(s, dim=-1), v_cache)


def _decode_bias(k_pos, length, window: int):
    ok = k_pos < length
    if window:
        ok &= k_pos > length - 1 - window
    return torch.where(ok, 0.0, NEG_INF)[None, None, None]


def _decode_on_mesh(q, k_cache, v_cache, length, window: int):
    """:func:`attention_decode` where the cache keeps its layout on the mesh
    (the sequence split on ``model``: context-parallel decode): each rank
    scores the query, every head, against its own cache positions, and the
    softmax's max, its sum and the weighted values are reduced over the
    ranks that split the sequence (flash-decoding's combine; the sum of the
    weighted values in float32).  Returns a DTensor split like the cache's
    batch."""
    from torch.distributed._functional_collectives import all_reduce
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, place = k_cache.device_mesh, list(k_cache.placements)
    seq = [(mesh, i) for i, p in enumerate(place) if p == Shard(1)]
    q_place = [Replicate() if p == Shard(1) else p for p in place]
    ql = q.redistribute(mesh, q_place).to_local()
    kl, vl = k_cache.to_local(), v_cache.to_local()
    _, offset = compute_local_shape_and_global_offset(k_cache.shape, mesh, place)
    if isinstance(length, DTensor):
        length = length.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
    k_pos = offset[1] + torch.arange(kl.shape[1], device=kl.device)
    s = _gqa_scores(ql, kl) + _decode_bias(k_pos, length, window)   # (B, Hq, 1, S_loc)
    m = s.amax(dim=-1, keepdim=True)
    for group in seq:
        m = all_reduce(m, "max", group)
    p = torch.exp(s - m)
    total = p.sum(dim=-1)                                            # (B, Hq, 1)
    o = _gqa_out(p, vl).float()                                      # (B, 1, Hq, dh)
    for group in seq:
        total = all_reduce(total, "sum", group)
        o = all_reduce(o, "sum", group)
    o = (o / total.transpose(1, 2)[..., None]).to(vl.dtype)
    shape = tuple(q.shape)
    stride = (shape[1] * shape[2] * shape[3], shape[2] * shape[3], shape[3], 1)
    return DTensor.from_local(o, mesh, q_place, run_check=False, shape=shape, stride=stride)


# ---------------------------------------------------------------------------
# Parameterized modules (init + apply as plain functions over dicts).
# ---------------------------------------------------------------------------

class ShapesOnly:
    """Stands in for the generator of ``init_params`` (and the ``init_*``
    functions it calls) to make meta tensors: the tree's shapes and dtypes,
    with no draws and no memory (a meta device has no generator)."""

    device = torch.device("meta")


def _normal(gen, shape, dtype, scale):
    """``scale`` times standard normal draws from ``gen`` on its device,
    drawn in fp32 and cast, so one seed gives one model in every dtype.
    A meta tensor of ``dtype`` for :class:`ShapesOnly`."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
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
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = split_heads(q, hq), split_heads(k, hkv), split_heads(v, hkv)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope_on:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = shard_activation(q, "attn_q")
    k = shard_activation(k, "attn_kv")
    v = shard_activation(v, "attn_kv")
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
