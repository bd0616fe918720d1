"""Generic decoder/encoder LM assembled from ModelConfig: the counterpart of
``repro/models/transformer.py``.

One code path covers the ten architectures of ``configs``:

  dense   : x += attn(ln1 x); x += mlp(ln2 x)
  moe     : x += attn(ln1 x); x += moe(ln2 x)
  ssm     : x += ssd(ln1 x)                       (Mamba-2: no attention, no MLP)
  hybrid  : x += ½(attn + ssd)(ln1 x); x += mlp(ln2 x)   (Hymba's parallel heads)
  vlm     : dense, with a cross-attention layer after every ``cross_attn_every``
  audio   : encoder-only dense (no causal mask, ``frames @ frontend`` input)

Layers run as a Python loop over the stacked layer axis (``repro``'s
``lax.scan``): each call splits every stacked leaf into its layers once,
with ``torch.unbind``, whose backward is one ``stack`` (indexing layer ``i``
of a leaf would add into a zero tensor of the whole stack, once per layer,
in the backward pass).  ``cfg.remat`` checkpoints each block under autograd
as ``repro``'s ``_remat`` does; the VLM's cross-attention layers lie
outside the checkpointed blocks, as in ``repro``.  ``lm_loss`` is
``repro``'s training loss.

Serving keeps ``repro``'s caches: a KV cache per layer (a rolling buffer
of ``sliding_window`` slots where the config has one), the SSM's ``(conv,
s)`` state per layer, the image keys and values of each cross-attention
layer, and an int32 ``length`` that stays on the device so a decode step
never waits on the host.  ``decode_step`` writes the new
token's k/v and the new SSM state into the cache tensors in place
(``repro`` returns a new cache; copying every layer's cache each step would
move the whole cache for one token).

Under an activation policy (``models/sharding.py``: parameters and batch
as DTensors on a ``DeviceMesh``) the residual stream and the logits carry
``repro``'s constraints; each block section and the LM head take their
input with the sequence gathered and the batch split (``batch_split``, the
Megatron-SP shape of ``repro``'s "block_compute"), which DTensor's view
rules need before a product; attention and the SSD run on each rank's
heads (``on_local_heads``, ``ssm.py``), and decode keeps the cache's
sequence split (``_decode_on_mesh``, ``_write_slot``); and
``_moe_dispatch`` picks the MoE's engine as
``repro``'s does: ``moe_apply_shard_map`` for ``moe_impl="shard_map"``
where the mesh divides the batch, the sequence and the experts, else
``moe_apply`` partitioned by DTensor.  Without a policy every constraint is
the identity and the MoE is ``moe_apply``.  Decode steps are dropless
``moe_apply``, as in ``repro``.
"""
from __future__ import annotations

from functools import partial
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

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
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.moe import init_moe, moe_apply, moe_apply_shard_map
from repro_torch.models.sharding import (
    batch_split,
    cache_sharding_tree,
    get_policy,
    replicated,
    shard_activation,
    split_heads,
    use_policy,
    zeros_placed,
)
from repro_torch.train.tree import tree_map
from repro_torch.models.ssm import (
    init_ssm,
    init_ssm_state,
    ssm_apply,
    ssm_decode,
    ssm_prefill_state,
)

Params = dict[str, Any]

__all__ = ["init_params", "params_from_numpy", "forward", "lm_loss", "init_cache",
           "decode_step", "prefill"]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _unbind(tree: Params) -> list[Params]:
    """The layers of a stacked parameter tree, each leaf split once."""
    split = {k: _unbind(v) if isinstance(v, dict) else torch.unbind(v)
             for k, v in tree.items()}
    n = len(next(iter(split.values())))
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def _layers(params: Params, cfg: ModelConfig) -> tuple[list[Params], list[Params] | None]:
    """(the blocks, the cross-attention layers or None), each unbound."""
    return (_unbind(params["blocks"]),
            _unbind(params["cross"]) if cfg.n_cross_layers else None)


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
    one model in every dtype.  ``generator=layers.ShapesOnly()`` makes the
    tree on the meta device (``launch/specs.py``)."""
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


def _moe_dispatch(mp, h, cfg):
    """Select the MoE execution engine (``repro``'s ``_moe_dispatch``)."""
    policy = get_policy()
    if policy is not None and cfg.moe_impl == "shard_map":
        sizes = axis_sizes(policy.mesh)
        tp = sizes.get("model", 1)
        dp = 1
        for a in ("pod", "data"):
            dp *= sizes.get(a, 1)
        seq_ok = h.shape[1] % tp == 0 and h.shape[0] % dp == 0
        experts_ok = cfg.moe_shard != "expert" or cfg.n_experts % tp == 0
        if seq_ok and experts_ok:
            return moe_apply_shard_map(mp, h, cfg, policy)
    return moe_apply(mp, h, cfg)


def _ffn(cfg: ModelConfig, x, bp, *, dropless: bool):
    """The block's second half: ``x += moe(ln2 x)`` or ``mlp(ln2 x)``.
    Returns (x, the MoE's aux loss terms, empty elsewhere).  A full
    sequence goes through ``_moe_dispatch``; a decode step (``dropless``)
    through ``moe_apply``."""
    if cfg.is_moe:
        h = rms_norm(x, bp["ln2"], cfg.norm_eps)
        m, aux = (moe_apply(bp["moe"], h, cfg, dropless=True) if dropless
                  else _moe_dispatch(bp["moe"], h, cfg))
        return x + m, aux
    if cfg.d_ff:
        h = batch_split(rms_norm(x, bp["ln2"], cfg.norm_eps))
        return x + batch_split(mlp_apply(bp["mlp"], h, cfg)), {}
    return x, {}


def _block(cfg: ModelConfig, x, bp, positions, *, ssm_state: bool = False):
    """One block. Returns (x, aux, k, v, st): aux holds the MoE's loss terms
    (empty elsewhere); k, v are the layer's keys and values for prefill's
    cache (None in an attention-free block); st is the SSM's ``(conv, s)``
    after the sequence where ``ssm_state`` asks for it, else None."""
    h = shard_activation(rms_norm(x, bp["ln1"], cfg.norm_eps), "residual")
    h = batch_split(h)          # on a mesh: the section gathers the sequence
    delta, k, v, st = 0.0, None, None, None
    if cfg.has_attention:
        delta, k, v = _self_attention(bp["attn"], h, cfg, positions)
    if cfg.has_ssm:
        delta = (delta + ssm_apply(bp["ssm"], h, cfg)) * _ssm_scale(cfg)
        if ssm_state:
            st = ssm_prefill_state(bp["ssm"], h, cfg)
    # The section's output, and its gradient, keep that shape.
    x, aux = _ffn(cfg, x + batch_split(delta), bp, dropless=False)
    return shard_activation(x, "residual"), aux, k, v, st


def _save_dots(ctx, op, *args, **kwargs):
    """``"dots"``: keep the products with no batch dimensions (``mm``,
    ``addmm``: every ``x @ W``), recompute the rest; ``repro``'s
    ``checkpoint_dots_with_no_batch_dims``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` checkpointed by ``cfg.remat`` where autograd records: ``"none"``
    saves what autograd saves, ``"dots"`` keeps only ``_save_dots``'s
    products, anything else recomputes the whole block.  Remat changes what
    the backward pass keeps, never a number."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    policy = get_policy()
    if policy is not None:
        # The recomputation runs on autograd's thread (a card's backward
        # has its own), where the thread-local policy is not set: it must
        # recompute what the forward computed.
        step = fn

        def fn(*args):
            with use_policy(policy):
                return step(*args)
    if cfg.remat == "dots":
        return partial(checkpoint, fn, use_reentrant=False,
                       context_fn=partial(create_selective_checkpoint_contexts, _save_dots))
    return partial(checkpoint, fn, use_reentrant=False)


def _scan_blocks(cfg, x, blocks, positions, layers, *, on_layer=None):
    """The blocks ``layers`` (indices into ``blocks``, the unbound layers) in
    order. Returns (x, their aux losses summed, fp32). ``on_layer(i, k, v,
    st)`` receives layer i's keys, values and SSM state (prefill's cache);
    without it each block runs under ``_remat``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if on_layer is None:
        def step(x, aux, bp):
            x, a, *_ = _block(cfg, x, bp, positions)
            return x, aux + sum(a.values()) if a else aux

        step = _remat(step, cfg)
        for i in layers:
            x, aux = step(x, aux, blocks[i])
        return x, aux
    for i in layers:
        x, a, k, v, st = _block(cfg, x, blocks[i], positions, ssm_state=True)
        if a:
            aux = aux + sum(a.values())
        on_layer(i, k, v, st)
    return x, aux


def _cross_kv(cfg: ModelConfig, cp, img):
    """A cross-attention layer's keys and values over the image embeddings."""
    return (split_heads(img @ cp["attn"]["wk"], cfg.n_kv_heads),
            split_heads(img @ cp["attn"]["wv"], cfg.n_kv_heads))


def _cross_block(cfg: ModelConfig, x, cp, k, v):
    """Cross-attention layer (VLM): queries from the text, keys and values
    ``k``, ``v`` from the image (``_cross_kv``); no RoPE, no mask."""
    h = rms_norm(x, cp["ln"], cfg.norm_eps)
    b, l, _ = h.shape
    q = split_heads(h @ cp["attn"]["wq"], cfg.n_heads)
    o = attention_dense(q, k, v, torch.arange(l, device=x.device),
                        torch.arange(k.shape[1], device=x.device), causal=False)
    return x + o.reshape(b, l, -1) @ cp["attn"]["wo"]


def _embed(params: Params, cfg: ModelConfig, tokens, frames):
    """The first residual: ``frames @ frontend`` (audio, frames cast to the
    model's dtype) or the token embedding."""
    if cfg.frontend_dim:
        return frames.to(_dtype(cfg)) @ params["frontend"]
    return params["embed"][replicated(tokens.long())]


def forward(params: Params, cfg: ModelConfig, tokens, *, img=None, frames=None):
    """Full-sequence forward. Returns (logits, aux_loss): aux is the MoE
    layers' loss terms summed (a 0 fp32 scalar for the other families).

    tokens: (B, L) integer, or None for frame inputs (audio).
    img:    (B, vision_seq, D) image embeddings (vlm), in the model's dtype
            (``repro`` would promote a wider one; torch refuses the product).
    frames: (B, L, frontend_dim) frame features (audio).
    """
    x = shard_activation(_embed(params, cfg, tokens, frames), "residual")
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    blocks, cross = _layers(params, cfg)
    for g, layers in enumerate(_groups(cfg)):
        x, a = _scan_blocks(cfg, x, blocks, positions, layers)
        if cross:
            x = _cross_block(cfg, x, cross[g], *_cross_kv(cfg, cross[g], img))
        aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return shard_activation(batch_split(x) @ _head(params, cfg), "logits"), aux


def _reduced(x):
    """``x`` with every partial placement of a DTensor reduced: the gather
    of the gold logits from vocab-sharded logits leaves a masked partial sum,
    which DTensor cannot reduce-scatter once indexed; reduced in place it is
    one all-reduce of (B, L, 1).  A plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in x.placements])


def lm_loss(params: Params, cfg: ModelConfig, batch: dict):
    """Causal-LM (or frame-classification) cross-entropy + aux losses:
    ``repro``'s ``lm_loss``.  Returns (loss, {"ce", "aux"}), fp32 scalars.

    ``batch``: ``labels`` (B, L) integer (a label < 0 is masked out),
    ``tokens``, ``img``, ``frames`` as ``forward`` takes them, except that
    ``img`` is cast to the model's dtype here (``SyntheticLMData`` draws it
    in float32; ``repro`` promotes the product instead).
    """
    img = batch.get("img")
    logits, aux = forward(params, cfg, batch.get("tokens"), frames=batch.get("frames"),
                          img=None if img is None else img.to(_dtype(cfg)))
    labels = batch["labels"].long()
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    # A masked label's gather reads column 0; the mask zeroes its term.
    gold = _reduced(torch.gather(logits, -1, labels.clamp(min=0)[..., None]))[..., 0]
    mask = (labels >= 0).to(torch.float32)
    ce = ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce + aux, {"ce": ce, "aux": aux}


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


def _write_slot(cache_t, slot, new) -> None:
    """``cache_t[:, slot] = new`` in place (``slot`` a one-element index).
    On a mesh each rank writes into its own shard of the cache: where its
    part of the sequence holds the slot, the new row, else the row it
    has."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    if not isinstance(cache_t, DTensor):
        cache_t.index_copy_(1, slot, new)
        return
    mesh, place = cache_t.device_mesh, list(cache_t.placements)
    local = cache_t.to_local()
    _, offset = compute_local_shape_and_global_offset(cache_t.shape, mesh, place)
    new = new.redistribute(mesh, [p if p == Shard(0) else Replicate() for p in place]).to_local()
    if isinstance(slot, DTensor):
        slot = slot.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
    at = slot - offset[1]
    inside = (at >= 0) & (at < local.shape[1])
    at = at.clamp(0, local.shape[1] - 1)
    local.index_copy_(1, at, torch.where(inside, new, local.index_select(1, at)))


def _write_layer(cache_t, i: int, new) -> None:
    """``cache_t[i, :, :n] = new`` in place (``n = new.shape[1]``).  On a
    mesh each rank writes into its own shard of the cache the part of
    ``new`` that falls in it (DTensor would write a slice of a split dim
    into a gathered copy)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    n = new.shape[1]
    if not isinstance(cache_t, DTensor):
        cache_t[i, :, :n] = new
        return
    mesh, place = cache_t.device_mesh, list(cache_t.placements)
    local = cache_t.to_local()
    _, offset = compute_local_shape_and_global_offset(cache_t.shape, mesh, place)
    # new's dims split as the cache's, but the one written in part: whole.
    want = [Shard(p.dim - 1) if isinstance(p, Shard) and p.dim not in (0, 2) else Replicate()
            for p in place]
    new = new.redistribute(mesh, want).to_local()
    lo = offset[2]
    hi = min(lo + local.shape[2], n)
    if lo < hi:
        local[i, :, :hi - lo] = new[:, lo:hi]


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
        _write_slot(k_cache, slot.long(), k)
        _write_slot(v_cache, slot.long(), v)
        if cfg.sliding_window:
            # Rolling buffer: every slot < length is valid; window == size.
            o = attention_decode(q, k_cache, v_cache, torch.clamp(length, max=s))
        else:
            o = attention_decode(q, k_cache, v_cache, length)
        delta = o.reshape(*x.shape[:2], -1) @ bp["attn"]["wo"]
    if cfg.has_ssm:
        st = cache["ssm"]
        y, new = ssm_decode(bp["ssm"], h, {"conv": st["conv"][i], "s": st["s"][i]}, cfg)
        _write_layer(st["conv"], i, new["conv"])
        _write_layer(st["s"], i, new["s"])
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
    blocks, cross = _layers(params, cfg)
    for g, layers in enumerate(_groups(cfg)):
        for i in layers:
            x = _decode_block(cfg, x, blocks[i], cache, i, length)
        if cross:
            cp = cross[g]
            h = rms_norm(x, cp["ln"], cfg.norm_eps)
            q = split_heads(h @ cp["attn"]["wq"], cfg.n_heads)
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
    x = shard_activation(_embed(params, cfg, tokens, frames), "residual")
    b, l = x.shape[:2]
    dev = x.device
    max_len = max_len or l
    # As in repro, a prompt longer than a full-attention cache keeps every
    # position.
    size = max_len if cfg.sliding_window else max(max_len, l)
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        # On a mesh: the cache laid out as a decode step takes it, each rank
        # allocating its shards.
        mesh = x.device_mesh
        meta = init_cache(cfg, b, size, device="meta")
        cache = tree_map(lambda t, s: zeros_placed(t, s, mesh, dev), meta,
                         cache_sharding_tree(meta, cfg, mesh, b))
    else:
        cache = init_cache(cfg, b, size, device=dev)
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
            _write_layer(cache["k"], i, k)
            _write_layer(cache["v"], i, v)
        if st is not None:
            _write_layer(cache["ssm"]["conv"], i, st["conv"])
            _write_layer(cache["ssm"]["s"], i, st["s"])

    positions = torch.arange(l, device=dev)
    blocks, cross = _layers(params, cfg)
    for g, layers in enumerate(_groups(cfg)):
        x, _ = _scan_blocks(cfg, x, blocks, positions, layers, on_layer=store)
        if cross:
            cp = cross[g]
            k, v = _cross_kv(cfg, cp, img)
            x = _cross_block(cfg, x, cp, k, v)
            cache["cross_k"][g] = k
            cache["cross_v"][g] = v
    cache["length"] = torch.full((), l, dtype=torch.int32, device=dev)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return batch_split(x) @ _head(params, cfg), cache
