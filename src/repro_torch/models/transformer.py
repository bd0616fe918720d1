"""Generic decoder/encoder LM assembled from ModelConfig: the counterpart of
``repro/models/transformer.py`` (all but training's ``lm_loss`` and remat).

One code path covers the ten architectures of ``configs``:

  dense   : x += attn(ln1 x); x += mlp(ln2 x)
  moe     : x += attn(ln1 x); x += moe(ln2 x)
  ssm     : x += ssd(ln1 x)                       (Mamba-2: no attention, no MLP)
  hybrid  : x += ½(attn + ssd)(ln1 x); x += mlp(ln2 x)   (Hymba's parallel heads)
  vlm     : dense, with a cross-attention layer after every ``cross_attn_every``
  audio   : encoder-only dense (no causal mask, ``frames @ frontend`` input)

Layers run as a Python loop over the stacked layer axis (``repro``'s
``lax.scan``).  Serving keeps ``repro``'s caches: a KV cache per layer (a
rolling buffer of ``sliding_window`` slots where the config has one), the
SSM's ``(conv, s)`` state per layer, the image keys and values of each
cross-attention layer, and an int32 ``length`` that stays on the device so
a decode step never waits on the host.  ``decode_step`` writes the new
token's k/v and the new SSM state into the cache tensors in place
(``repro`` returns a new cache; copying every layer's cache each step would
move the whole cache for one token).

MoE layers run ``moe_apply`` (``repro``'s ``_moe_dispatch`` with no
activation policy set); decode steps are dropless, as in ``repro``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    _normal,
    attention_chunked,
    attention_decode,
    attention_dense,
    init_attn,
    init_mlp,
    mlp_apply,
    qkv_project,
    rms_norm,
)
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.models.ssm import (
    init_ssm,
    init_ssm_state,
    ssm_apply,
    ssm_decode,
    ssm_prefill_state,
)

Params = dict[str, Any]

__all__ = ["init_params", "params_from_numpy", "forward", "init_cache",
           "decode_step", "prefill"]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a stacked parameter tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _head(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _groups(cfg: ModelConfig) -> list[range]:
    """The runs of layers between cross-attention layers (VLM: group g is
    followed by cross layer g); one run of every layer elsewhere."""
    if cfg.n_cross_layers:
        ce = cfg.cross_attn_every
        return [range(g * ce, (g + 1) * ce) for g in range(cfg.n_cross_layers)]
    return [range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# Init.
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Random parameters, drawn from ``generator`` on the generator's device.
    Same tree paths, shapes, scales and dtypes as ``repro``'s
    ``init_params`` (``cfg.dtype``; the MoE router and the SSM's per-head
    scalars in float32), not the same numbers: the two frameworks draw
    differently.  Draws are fp32 cast to ``cfg.dtype``, so one seed gives
    one model in every dtype."""
    dt = _dtype(cfg)
    dev = generator.device
    d, n_layers = cfg.d_model, cfg.n_layers
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=dev)  # noqa: E731
    p: Params = {}
    if cfg.frontend_dim:
        p["frontend"] = _normal(generator, (cfg.frontend_dim, d), dt,
                                cfg.frontend_dim ** -0.5)
    p["embed"] = _normal(generator, (cfg.vocab_size, d), dt, 0.02)
    blocks: Params = {"ln1": ones(n_layers, d)}
    if cfg.has_attention:
        blocks["attn"] = init_attn(generator, cfg, layers=n_layers, dtype=dt)
    if cfg.has_ssm:
        blocks["ssm"] = init_ssm(generator, cfg, layers=n_layers, dtype=dt)
    if cfg.is_moe:
        blocks["ln2"] = ones(n_layers, d)
        blocks["moe"] = init_moe(generator, cfg, layers=n_layers, dtype=dt)
    elif cfg.d_ff:
        blocks["ln2"] = ones(n_layers, d)
        blocks["mlp"] = init_mlp(generator, cfg, layers=n_layers, dtype=dt)
    p["blocks"] = blocks
    if cfg.n_cross_layers:
        lc = cfg.n_cross_layers
        p["cross"] = {"ln": ones(lc, d),
                      "attn": init_attn(generator, cfg, layers=lc, dtype=dt)}
    p["final_norm"] = ones(d)
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal(generator, (d, cfg.vocab_size), dt, d ** -0.5)
    return p


def params_from_numpy(tree, *, device) -> Params:
    """``repro``'s parameter tree, as numpy arrays (``jax.tree.map(np.asarray,
    params)``), to the port's: the same paths, layouts and dtypes (bfloat16
    leaves included), no transposes."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":      # ml_dtypes' type: torch reads its bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


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


def _ssm_scale(cfg: ModelConfig) -> float:
    """Hymba averages its parallel attention and SSM heads."""
    return 0.5 if cfg.parallel_ssm and cfg.has_attention else 1.0


def _ffn(cfg: ModelConfig, x, bp, *, dropless: bool):
    """The block's second half: ``x += moe(ln2 x)`` or ``mlp(ln2 x)``.
    Returns (x, the MoE's aux loss terms, empty elsewhere)."""
    if cfg.is_moe:
        m, aux = moe_apply(bp["moe"], rms_norm(x, bp["ln2"], cfg.norm_eps), cfg,
                           dropless=dropless)
        return x + m, aux
    if cfg.d_ff:
        return x + mlp_apply(bp["mlp"], rms_norm(x, bp["ln2"], cfg.norm_eps), cfg), {}
    return x, {}


def _block(cfg: ModelConfig, x, bp, positions, *, ssm_state: bool = False):
    """One block. Returns (x, aux, k, v, st): aux holds the MoE's loss terms
    (empty elsewhere); k, v are the layer's keys and values for prefill's
    cache (None in an attention-free block); st is the SSM's ``(conv, s)``
    after the sequence where ``ssm_state`` asks for it, else None."""
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    delta, k, v, st = 0.0, None, None, None
    if cfg.has_attention:
        delta, k, v = _self_attention(bp["attn"], h, cfg, positions)
    if cfg.has_ssm:
        delta = (delta + ssm_apply(bp["ssm"], h, cfg)) * _ssm_scale(cfg)
        if ssm_state:
            st = ssm_prefill_state(bp["ssm"], h, cfg)
    x, aux = _ffn(cfg, x + delta, bp, dropless=False)
    return x, aux, k, v, st


def _scan_blocks(cfg, x, blocks, positions, layers, *, on_layer=None):
    """The blocks ``layers`` in order. Returns (x, their aux losses summed,
    fp32). ``on_layer(i, k, v, st)`` receives layer i's keys, values and
    SSM state (prefill's cache)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in layers:
        x, a, k, v, st = _block(cfg, x, _layer(blocks, i), positions,
                                ssm_state=on_layer is not None)
        if a:
            aux = aux + sum(a.values())
        if on_layer is not None:
            on_layer(i, k, v, st)
    return x, aux


def _cross_kv(cfg: ModelConfig, cp, img):
    """A cross-attention layer's keys and values over the image embeddings."""
    shape = (img.shape[0], img.shape[1], cfg.n_kv_heads, cfg.head_dim)
    return ((img @ cp["attn"]["wk"]).reshape(shape),
            (img @ cp["attn"]["wv"]).reshape(shape))


def _cross_block(cfg: ModelConfig, x, cp, k, v):
    """Cross-attention layer (VLM): queries from the text, keys and values
    ``k``, ``v`` from the image (``_cross_kv``); no RoPE, no mask."""
    h = rms_norm(x, cp["ln"], cfg.norm_eps)
    b, l, _ = h.shape
    q = (h @ cp["attn"]["wq"]).reshape(b, l, cfg.n_heads, cfg.head_dim)
    o = attention_dense(q, k, v, torch.arange(l, device=x.device),
                        torch.arange(k.shape[1], device=x.device), causal=False)
    return x + o.reshape(b, l, -1) @ cp["attn"]["wo"]


def _embed(params: Params, cfg: ModelConfig, tokens, frames):
    """The first residual: ``frames @ frontend`` (audio, frames cast to the
    model's dtype) or the token embedding."""
    if cfg.frontend_dim:
        return frames.to(_dtype(cfg)) @ params["frontend"]
    return params["embed"][tokens.long()]


def forward(params: Params, cfg: ModelConfig, tokens, *, img=None, frames=None):
    """Full-sequence forward. Returns (logits, aux_loss): aux is the MoE
    layers' loss terms summed (a 0 fp32 scalar for the other families).

    tokens: (B, L) integer, or None for frame inputs (audio).
    img:    (B, vision_seq, D) image embeddings (vlm), in the model's dtype
            (``repro`` would promote a wider one; torch refuses the product).
    frames: (B, L, frontend_dim) frame features (audio).
    """
    x = _embed(params, cfg, tokens, frames)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g, layers in enumerate(_groups(cfg)):
        x, a = _scan_blocks(cfg, x, params["blocks"], positions, layers)
        if cfg.n_cross_layers:
            cp = _layer(params["cross"], g)
            x = _cross_block(cfg, x, cp, *_cross_kv(cfg, cp, img))
        aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ _head(params, cfg), aux


# ---------------------------------------------------------------------------
# Serving: prefill + decode with (KV | SSM | rolling-window | image) caches.
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda") -> dict:
    """Cache dict with ``repro``'s keys. Sliding-window configs use a
    rolling buffer of ``window`` slots."""
    dt = _dtype(cfg)
    n_layers = cfg.n_layers
    cache: dict[str, Any] = {"length": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.has_attention:
        s = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
        kv_shape = (n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim)
        cache["k"] = torch.zeros(kv_shape, dtype=dt, device=device)
        cache["v"] = torch.zeros(kv_shape, dtype=dt, device=device)
    if cfg.has_ssm:
        cache["ssm"] = {name: t.new_zeros((n_layers, *t.shape)) for name, t
                        in init_ssm_state(cfg, batch, device=device).items()}
    if cfg.n_cross_layers:
        shape = (cfg.n_cross_layers, batch, cfg.vision_seq, cfg.n_kv_heads, cfg.head_dim)
        cache["cross_k"] = torch.zeros(shape, dtype=dt, device=device)
        cache["cross_v"] = torch.zeros(shape, dtype=dt, device=device)
    return cache


def _decode_block(cfg, x, bp, cache, i, length):
    """Block ``i``, one token; writes the token's k/v and the new SSM state
    into layer i of the cache tensors in place."""
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    delta = 0.0
    if cfg.has_attention:
        k_cache, v_cache = cache["k"][i], cache["v"][i]
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
        delta = o.reshape(*x.shape[:2], -1) @ bp["attn"]["wo"]
    if cfg.has_ssm:
        st = cache["ssm"]
        y, new = ssm_decode(bp["ssm"], h, {"conv": st["conv"][i], "s": st["s"][i]}, cfg)
        st["conv"][i] = new["conv"]
        st["s"][i] = new["s"]
        delta = (delta + y) * _ssm_scale(cfg)
    x, _ = _ffn(cfg, x + delta, bp, dropless=True)   # decode: no drops
    return x


def decode_step(params: Params, cfg: ModelConfig, token, cache):
    """One autoregressive step. token: (B, 1) integer. Returns (logits, cache);
    the returned cache holds the same tensors, updated in place.

    RoPE note: keys are stored *rotated* at their absolute position, so the
    rolling window buffer needs no re-rotation.
    """
    x = params["embed"][token.long()]
    length = cache["length"] + 1
    for g, layers in enumerate(_groups(cfg)):
        for i in layers:
            x = _decode_block(cfg, x, _layer(params["blocks"], i), cache, i, length)
        if cfg.n_cross_layers:
            cp = _layer(params["cross"], g)
            h = rms_norm(x, cp["ln"], cfg.norm_eps)
            q = (h @ cp["attn"]["wq"]).reshape(x.shape[0], 1, cfg.n_heads, cfg.head_dim)
            o = attention_decode(q, cache["cross_k"][g], cache["cross_v"][g],
                                 cfg.vision_seq)
            x = x + o.reshape(x.shape[0], 1, -1) @ cp["attn"]["wo"]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ _head(params, cfg), {**cache, "length": length}


def prefill(params: Params, cfg: ModelConfig, tokens, *, img=None, frames=None,
            max_len: int | None = None):
    """Process a full prompt; returns (last-token logits, primed cache).

    The full-sequence forward plus cache extraction, in one pass; chunked
    attention for long prompts.  The KV slots past the prompt stay zero
    (``repro``'s ``_pad_kv``); the SSM state is ``repro``'s closed form
    (``ssm_prefill_state``); each cross-attention layer's image keys and
    values are computed once.  ``img`` and ``frames`` as in ``forward``.
    """
    x = _embed(params, cfg, tokens, frames)
    b, l = x.shape[:2]
    dev = x.device
    max_len = max_len or l
    # As in repro, a prompt longer than a full-attention cache keeps every
    # position.
    cache = init_cache(cfg, b, max_len if cfg.sliding_window else max(max_len, l),
                       device=dev)
    rolling = cfg.has_attention and bool(cfg.sliding_window) and l > cache["k"].shape[2]
    if rolling:
        # Keep the last `s` positions in rolling order (slot = pos % s).
        s = cache["k"].shape[2]
        pos = l - s + torch.arange(s, device=dev)
        take = torch.zeros((s,), dtype=torch.int64, device=dev)
        take[pos % s] = pos

    def store(i, k, v, st):
        if k is not None:
            if rolling:
                k, v = k[:, take], v[:, take]
            cache["k"][i, :, :k.shape[1]] = k
            cache["v"][i, :, :v.shape[1]] = v
        if st is not None:
            cache["ssm"]["conv"][i] = st["conv"]
            cache["ssm"]["s"][i] = st["s"]

    positions = torch.arange(l, device=dev)
    for g, layers in enumerate(_groups(cfg)):
        x, _ = _scan_blocks(cfg, x, params["blocks"], positions, layers, on_layer=store)
        if cfg.n_cross_layers:
            cp = _layer(params["cross"], g)
            k, v = _cross_kv(cfg, cp, img)
            x = _cross_block(cfg, x, cp, k, v)
            cache["cross_k"][g] = k
            cache["cross_v"][g] = v
    cache["length"] = torch.full((), l, dtype=torch.int32, device=dev)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return x @ _head(params, cfg), cache
