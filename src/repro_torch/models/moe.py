"""Mixture-of-Experts layer: top-k router and capacity dispatch.

The counterpart of ``repro/models/moe.py``: ``init_moe``, ``moe_apply``
(GShard/Switch-style capacity dispatch, which DTensor partitions under a
policy: ``moe_impl="gspmd"``) and ``moe_apply_shard_map``, the expert layer
with explicit distribution on a mesh's ``"model"`` axis.  The router runs in
float32 whatever the model's dtype; the experts are SiLU-gated FFNs
(``silu(x W_g) * (x W_i)``) for every config, as in ``repro``, whatever
``cfg.act`` says.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import axis_names, axis_sizes
from repro_torch.models.layers import Params, _normal
from repro_torch.models.sharding import P, batch_split, placements, replicated


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
        for i in range(layers if w.device.type != "meta" else 0):
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


def _dispatch(xt, router, cfg, capacity):
    """Route ``xt`` (T, D): returns (logits, probs, gates, onehot, slot,
    disp).  Queue positions follow the token-major order of the ``(token,
    choice)`` pairs, as in ``repro``, so the same pairs drop; ``slot`` is
    each pair's row of ``disp`` (E, C, D), or the overflow row E·C."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    logits = xt.float() @ router                               # (T, E) fp32
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1, sorted=True)   # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
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
    disp = torch.zeros((e * capacity + 1, d), dtype=xt.dtype, device=xt.device).index_add(
        0, slot.reshape(-1), xt.repeat_interleave(k, dim=0))
    return logits, probs, gate_vals, onehot, slot, disp[:-1].reshape(e, capacity, d)


def _experts(disp, wi, wg, wo):
    """The expert FFNs, batched over the expert axis: (E, C, D) -> (E, C, D)."""
    h = F.silu(torch.bmm(disp, wg)) * torch.bmm(disp, wi)
    return torch.bmm(h, wo)


def _combine(out, slot, gate_vals):
    """Each (token, choice)'s expert output, weighted by its gate, summed
    over the choices: (T, D)."""
    e, c, d = out.shape
    out_flat = torch.cat([out.reshape(e * c, d), out.new_zeros((1, d))])
    return (out_flat[slot] * gate_vals[..., None].to(out.dtype)).sum(dim=1)


def _aux_terms(onehot, probs, logits, cfg):
    """Switch load balance and router z-loss, weighted by their coefs."""
    density = onehot.float().sum(1).mean(0)                    # (E,) token share
    lb_loss = cfg.n_experts * (density * probs.mean(0)).sum()
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    return cfg.router_lb_coef * lb_loss, cfg.router_z_coef * z_loss


def moe_apply(p, x, cfg, *, dropless: bool = False):
    """x: (B, L, D) -> ((B, L, D), aux losses dict).

    Top-k routing with a capacity per expert; a (token, choice) past its
    expert's capacity is dropped (its expert contribution is zero).
    ``dropless=True`` sizes the capacity to the worst case (decode steps).
    """
    b, l, d = x.shape
    capacity = moe_capacity(cfg, b * l, dropless=dropless)
    # On a mesh (DTensors, moe_impl "gspmd"): the routing, the capacity
    # scatter and the combine run on every token on every rank, as GSPMD
    # replicates the dispatch buffers; the expert products are split by the
    # experts' own placements.
    logits, probs, gate_vals, onehot, slot, disp = _dispatch(
        replicated(x).reshape(b * l, d), p["router"], cfg, capacity)
    out = replicated(_experts(disp, p["wi"], p["wg"], p["wo"]))
    combined = _combine(out, slot, gate_vals)
    lb, z = _aux_terms(onehot, probs, logits, cfg)
    return batch_split(combined.reshape(b, l, d)), {"moe_lb": lb, "moe_z": z}


def _local(t, mesh, spec, grad_spec):
    """The rank's shard of ``t`` (a DTensor, or a plain tensor every rank
    holds whole) by ``spec``, as a plain tensor.  ``grad_spec`` names the
    mesh axes over which the rank's gradient is a partial sum (axes that
    replicate ``t`` while each rank uses its own tokens)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    place = placements(spec, mesh)
    grads = [Partial() if a in grad_spec else pl
             for a, pl in zip(axis_names(mesh), place)]
    return t.redistribute(mesh, place).to_local(grad_placements=grads)


def moe_apply_shard_map(p, x, cfg, policy):
    """The expert layer with explicit distribution on the policy's mesh
    (``repro``'s ``moe_apply_shard_map``): each rank routes its own tokens
    and the only wire traffic is

      expert-sharded (E on ``model``): one ``all_to_all_single`` of the
        (E, C_loc, D) dispatch buffer on the ``model`` group out, (E, C, D) ->
        (E/ntp, C·ntp, D), and one back;
      tensor-sharded (d_ff on ``model``): the tokens of the rank's ``data``
        shard gathered over ``model``, then one reduction of the combined
        (T_loc, D) partial sums over the d_ff shards, scattered back along
        the sequence.  ``repro`` keeps the sequence split on ``model`` here
        and sums partial outputs of different tokens (ROADMAP.md §3); the
        port gathers it.

    Capacity comes from the rank's token count, so where capacity binds it
    drops other tokens than ``moe_apply``.  Differentiable: the all-to-all's
    backward is the inverse all-to-all, and the reductions are DTensor
    ``Partial`` placements.  The aux loss is the mean over every rank of
    its own tokens' aux, returned as ``{"moe": aux}`` (a replicated DTensor).
    """
    from torch.distributed.nn.functional import all_to_all_single
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = policy.mesh
    names = axis_names(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names)
    tp = "model"
    ntp = axis_sizes(mesh)[tp]
    e = cfg.n_experts
    if cfg.moe_shard == "expert":
        w_specs = (P(tp, None, None),) * 3
        x_spec, x_grad = P(dp, tp, None), ()
    else:
        w_specs = (P(None, None, tp), P(None, None, tp), P(None, tp, None))
        x_spec, x_grad = P(dp, None, None), (tp,)
    wr = _local(p["router"], mesh, P(None, None), names)
    wi, wg, wo = (_local(p[n], mesh, s, dp) for n, s in zip(("wi", "wg", "wo"), w_specs))
    xl = _local(x, mesh, x_spec, x_grad)

    b_loc, l_loc, d = xl.shape
    t = b_loc * l_loc
    logits, probs, gate_vals, onehot, slot, disp = _dispatch(
        xl.reshape(t, d), wr, cfg, moe_capacity(cfg, t))
    if cfg.moe_shard == "expert" and ntp > 1:
        c = disp.shape[1]
        group = mesh.get_group(tp)
        # (E, C, D) -> (E/ntp, C*ntp, D): tokens travel to their experts.
        got = all_to_all_single(torch.empty_like(disp), disp.contiguous(), group=group)
        got = got.reshape(ntp, e // ntp, c, d).transpose(0, 1).reshape(e // ntp, ntp * c, d)
        out = _experts(got, wi, wg, wo)
        out = out.reshape(e // ntp, ntp, c, d).transpose(0, 1).contiguous()
        out = all_to_all_single(torch.empty_like(out), out, group=group)
        out = out.reshape(e, c, d)                               # back to (E, C, D)
    else:
        out = _experts(disp, wi, wg, wo)
    combined = _combine(out, slot, gate_vals).reshape(b_loc, l_loc, d)

    out_place = placements(P(dp, tp, None), mesh)
    if cfg.moe_shard == "expert":
        y = DTensor.from_local(combined, mesh, out_place, run_check=False,
                               shape=x.shape, stride=x.stride())
    else:
        partial = [Partial() if a == tp else pl
                   for a, pl in zip(names, placements(x_spec, mesh))]
        y = DTensor.from_local(combined, mesh, partial, run_check=False,
                               shape=x.shape, stride=x.stride()).redistribute(mesh, out_place)
    lb, z = _aux_terms(onehot, probs, logits, cfg)
    aux = DTensor.from_local((lb + z) / mesh.size(), mesh, [Partial()] * mesh.ndim,
                             run_check=False)
    return y, {"moe": aux.redistribute(mesh, [Replicate()] * mesh.ndim)}
