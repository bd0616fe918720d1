"""Mixture-of-Experts layer: top-k router and capacity dispatch.

The counterpart of ``repro/models/moe.py``'s ``init_moe`` and
``moe_apply`` (GShard/Switch-style capacity dispatch on one device).  The
router runs in float32 whatever the model's dtype; the experts are
SiLU-gated FFNs (``silu(x W_g) * (x W_i)``) for every config, as in
``repro``, whatever ``cfg.act`` says.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, _normal


def init_moe(gen: torch.Generator, cfg, *, layers: int, dtype: torch.dtype) -> Params:
    """``repro``'s ``init_moe`` tree: router ``(L, d, E)`` in float32, expert
    weights ``(L, E, d, f)`` / ``(L, E, f, d)`` in ``dtype``.

    The expert tensors are drawn one expert of one layer at a time (float32
    draws cast into a preallocated ``dtype`` tensor), so a full-width model
    never holds a whole expert stack in float32 beside its result.
    """
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": _normal(gen, (layers, d, e), torch.float32, d ** -0.5)}
    for name, shape, scale in (("wi", (d, f), d ** -0.5), ("wg", (d, f), d ** -0.5),
                               ("wo", (f, d), f ** -0.5)):
        w = torch.empty((layers, e, *shape), dtype=dtype, device=gen.device)
        for i in range(layers):
            for j in range(e):
                w[i, j] = _normal(gen, shape, dtype, scale)
        p[name] = w
    return p


def moe_capacity(cfg, t: int, *, dropless: bool = False) -> int:
    """Each expert's queue length for ``t`` tokens: ``repro``'s rule."""
    if dropless:
        return t
    k, e = cfg.experts_per_token, cfg.n_experts
    return min(max(int(t * k * cfg.capacity_factor / e), 4), t)


def moe_apply(p, x, cfg, *, dropless: bool = False):
    """x: (B, L, D) -> ((B, L, D), aux losses dict).

    Top-k routing with a capacity per expert; a (token, choice) past its
    expert's capacity is dropped (its expert contribution is zero).  Queue
    positions follow the token-major order of the ``(token, choice)`` pairs,
    as in ``repro``, so the same pairs drop.  ``dropless=True`` sizes the
    capacity to the worst case (decode steps).
    """
    b, l, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    t = b * l
    xt = x.reshape(t, d)

    logits = xt.float() @ p["router"]                          # (T, E) fp32
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1, sorted=True)   # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    capacity = moe_capacity(cfg, t, dropless=dropless)

    # Position of each (token, choice) within its expert's queue: the count
    # of earlier pairs (token-major) routed to the same expert.
    onehot = F.one_hot(expert_ids, e)                          # (T, k, E)
    flat = onehot.reshape(t * k, e)
    ids = expert_ids.reshape(t * k, 1)
    pos = (torch.cumsum(flat, dim=0) - flat).gather(1, ids).reshape(t, k)
    fits = pos < capacity

    # Dispatch: scatter tokens into (E, C, D) buffers; row E*C is the
    # overflow sink.
    slot = torch.where(fits, expert_ids * capacity + pos, e * capacity)   # (T, k)
    disp = torch.zeros((e * capacity + 1, d), dtype=x.dtype, device=x.device)
    disp.index_add_(0, slot.reshape(-1), xt.repeat_interleave(k, dim=0))
    disp = disp[:-1].reshape(e, capacity, d)

    # Expert FFN (batched products over the expert axis).
    h = F.silu(torch.bmm(disp, p["wg"])) * torch.bmm(disp, p["wi"])
    out = torch.bmm(h, p["wo"])                                # (E, C, D)

    # Combine: gather each (token, choice)'s expert output, weighted.
    out_flat = torch.cat([out.reshape(e * capacity, d), out.new_zeros((1, d))])
    tok_out = out_flat[slot]                                   # (T, k, D)
    combined = (tok_out * gate_vals[..., None].to(out.dtype)).sum(dim=1)

    # Aux losses: Switch load balance and router z-loss.
    density = onehot.float().sum(1).mean(0)                    # (E,) token share
    lb_loss = e * (density * probs.mean(0)).sum()
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    aux = {"moe_lb": cfg.router_lb_coef * lb_loss, "moe_z": cfg.router_z_coef * z_loss}
    return combined.reshape(b, l, d), aux
