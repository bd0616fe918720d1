"""Dense decoder LM assembled from ModelConfig: the counterpart of the
dense path of ``repro/models/transformer.py``.

    dense : x += attn(ln1 x); x += mlp(ln2 x)

Layers run as a Python loop over the stacked layer axis (``repro``'s
``lax.scan``).  Serving keeps ``repro``'s caches: a KV cache per layer, a
rolling buffer of ``sliding_window`` slots where the config has one, and
an int32 ``length`` that stays on the device so a decode step never waits
on the host.  ``decode_step`` writes the new token's k/v into the cache
tensors in place (``repro`` returns a new cache; copying every layer's
cache each step would move the whole cache for one token).

MoE, SSM, cross-attention and audio-frontend configs raise
``NotImplementedError``: they are later slices (ROADMAP.md, queue 1 item
11).  Training (``lm_loss``, remat) waits for the training slice.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    attention_chunked,
    attention_decode,
    attention_dense,
    init_attn,
    init_mlp,
    mlp_apply,
    qkv_project,
    rms_norm,
)

Params = dict[str, Any]

__all__ = ["init_params", "params_from_numpy", "forward", "init_cache",
           "decode_step", "prefill"]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for the model families not ported yet."""
    missing = [name for name, needed in (
        ("MoE (models/moe.py)", cfg.is_moe),
        ("SSM (models/ssm.py)", cfg.has_ssm),
        ("cross-attention (VLM)", bool(cfg.n_cross_layers)),
        ("audio frontend", bool(cfg.frontend_dim)),
        ("attention-free blocks", not cfg.has_attention),
    ) if needed]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet; the port runs the "
            "dense decoder only (ROADMAP.md, queue 1 item 11)")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a stacked parameter tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _head(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# Init.
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Random parameters in ``cfg.dtype``, drawn from ``generator`` on the
    generator's device.  Same tree paths, shapes and scales as ``repro``'s
    ``init_params`` (not the same numbers: the two frameworks draw
    differently).  Draws are fp32 cast to ``cfg.dtype``, so one seed gives
    one model in every dtype."""
    check_supported(cfg)
    dt = _dtype(cfg)
    dev = generator.device
    d, n_layers = cfg.d_model, cfg.n_layers
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=dev)  # noqa: E731
    p: Params = {"embed": (torch.randn((cfg.vocab_size, d), generator=generator,
                                       device=dev) * 0.02).to(dt)}
    blocks: Params = {"ln1": ones(n_layers, d),
                      "attn": init_attn(generator, cfg, layers=n_layers, dtype=dt)}
    if cfg.d_ff:
        blocks["ln2"] = ones(n_layers, d)
        blocks["mlp"] = init_mlp(generator, cfg, layers=n_layers, dtype=dt)
    p["blocks"] = blocks
    p["final_norm"] = ones(d)
    if not cfg.tie_embeddings:
        p["lm_head"] = (torch.randn((d, cfg.vocab_size), generator=generator,
                                    device=dev) * d ** -0.5).to(dt)
    return p


def params_from_numpy(tree, *, device, dtype: torch.dtype | None = None) -> Params:
    """``repro``'s parameter tree, as numpy arrays (``jax.tree.map(np.asarray,
    params)``), to the port's: the same paths and layouts, no transposes."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device, dtype=dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree)).to(device)
    return t.to(dtype) if dtype is not None else t


# ---------------------------------------------------------------------------
# Blocks (full-sequence forward).
# ---------------------------------------------------------------------------

def _attend(q, k, v, positions, cfg):
    """Dense attention up to ``attn_chunk_threshold`` tokens, chunked above."""
    if q.shape[1] > cfg.attn_chunk_threshold:
        return attention_chunked(q, k, v, positions, positions, causal=cfg.causal,
                                 window=cfg.sliding_window,
                                 q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk)
    return attention_dense(q, k, v, positions, positions, causal=cfg.causal,
                           window=cfg.sliding_window)


def _self_attention(bp, x, cfg, positions):
    q, k, v = qkv_project(bp, x, cfg, positions)
    o = _attend(q, k, v, positions, cfg)
    return o.reshape(*x.shape[:2], -1) @ bp["wo"], k, v


def _block(cfg: ModelConfig, x, bp, positions):
    """One dense block. Returns (x, k, v): the layer's keys and values feed
    ``prefill``'s cache."""
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    delta, k, v = _self_attention(bp["attn"], h, cfg, positions)
    x = x + delta
    if cfg.d_ff:
        h2 = rms_norm(x, bp["ln2"], cfg.norm_eps)
        x = x + mlp_apply(bp["mlp"], h2, cfg)
    return x, k, v


def _scan_blocks(cfg, x, blocks, positions, *, on_kv=None):
    """Every layer in order; ``on_kv(i, k, v)`` receives layer i's keys and
    values."""
    for i in range(cfg.n_layers):
        x, k, v = _block(cfg, x, _layer(blocks, i), positions)
        if on_kv is not None:
            on_kv(i, k, v)
    return x


def forward(params: Params, cfg: ModelConfig, tokens):
    """Full-sequence forward. tokens: (B, L) integer. Returns (logits, aux_loss);
    the dense path has no auxiliary loss, so aux is a 0 fp32 scalar."""
    check_supported(cfg)
    x = params["embed"][tokens.long()]
    positions = torch.arange(tokens.shape[1], device=x.device)
    x = _scan_blocks(cfg, x, params["blocks"], positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ _head(params, cfg), torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Serving: prefill + decode with (KV | rolling-window) caches.
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda") -> dict:
    """Cache dict. Sliding-window configs use a rolling buffer of
    ``window`` slots."""
    check_supported(cfg)
    s = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    kv_shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim)
    return {"length": torch.zeros((), dtype=torch.int32, device=device),
            "k": torch.zeros(kv_shape, dtype=_dtype(cfg), device=device),
            "v": torch.zeros(kv_shape, dtype=_dtype(cfg), device=device)}


def _decode_block(cfg, x, bp, k_cache, v_cache, length):
    """One block, one token; writes the token's k/v into this layer's
    ``(B, S, Hkv, dh)`` cache views in place."""
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    pos = (length - 1).reshape(1)
    q, k, v = qkv_project(bp["attn"], h, cfg, pos)
    s = k_cache.shape[1]
    # repro's dynamic_update_slice clamps the slot into the buffer.
    slot = torch.remainder(pos, s) if cfg.sliding_window else pos.clamp(0, s - 1)
    k_cache.index_copy_(1, slot.long(), k)
    v_cache.index_copy_(1, slot.long(), v)
    if cfg.sliding_window:
        # Rolling buffer: every slot < length is valid; window == size.
        o = attention_decode(q, k_cache, v_cache, torch.clamp(length, max=s))
    else:
        o = attention_decode(q, k_cache, v_cache, length)
    x = x + o.reshape(*x.shape[:2], -1) @ bp["attn"]["wo"]
    if cfg.d_ff:
        h2 = rms_norm(x, bp["ln2"], cfg.norm_eps)
        x = x + mlp_apply(bp["mlp"], h2, cfg)
    return x


def decode_step(params: Params, cfg: ModelConfig, token, cache):
    """One autoregressive step. token: (B, 1) integer. Returns (logits, cache);
    the returned cache holds the same k/v tensors, updated in place.

    RoPE note: keys are stored *rotated* at their absolute position, so the
    rolling window buffer needs no re-rotation.
    """
    check_supported(cfg)
    x = params["embed"][token.long()]
    length = cache["length"] + 1
    for i in range(cfg.n_layers):
        x = _decode_block(cfg, x, _layer(params["blocks"], i), cache["k"][i],
                          cache["v"][i], length)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ _head(params, cfg), {**cache, "length": length}


def prefill(params: Params, cfg: ModelConfig, tokens, *, max_len: int | None = None):
    """Process a full prompt; returns (last-token logits, primed cache).

    The full-sequence forward plus cache extraction, in one pass; chunked
    attention for long prompts.  The cache slots past the prompt stay zero
    (``repro``'s ``_pad_kv``).
    """
    check_supported(cfg)
    b, l = tokens.shape
    max_len = max_len or l
    # As in repro, a prompt longer than a full-attention cache keeps every
    # position.
    cache = init_cache(cfg, b, max_len if cfg.sliding_window else max(max_len, l),
                       device=tokens.device)
    s = cache["k"].shape[2]
    rolling = bool(cfg.sliding_window) and l > s
    if rolling:
        # Keep the last `s` positions in rolling order (slot = pos % s).
        pos = l - s + torch.arange(s, device=tokens.device)
        take = torch.zeros((s,), dtype=torch.int64, device=tokens.device)
        take[pos % s] = pos

    def store(i, k, v):
        if rolling:
            k, v = k[:, take], v[:, take]
        cache["k"][i, :, :k.shape[1]] = k
        cache["v"][i, :, :v.shape[1]] = v

    x = params["embed"][tokens.long()]
    positions = torch.arange(l, device=tokens.device)
    x = _scan_blocks(cfg, x, params["blocks"], positions, on_kv=store)
    cache["length"] = torch.full((), l, dtype=torch.int32, device=tokens.device)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return x @ _head(params, cfg), cache
