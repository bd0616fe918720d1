"""AdamW with cosine schedule and global-norm clipping.

The counterpart of ``repro/train/optimizer.py``: the state mirrors the
parameter tree (``m``/``v`` in float32, an int32 ``step``), and the update
runs in ``repro``'s order, in float32 from the parameter cast up, cast back
to the parameter's dtype, the weight decay inside ``delta``.  Where
``repro`` donates the parameters and the state, the port updates their
tensors in place (under ``torch.no_grad()``) and returns the same dicts.
On a mesh the leaves are DTensors: ``m`` and ``v`` take each parameter's
placements, each rank updates its own shards in place (the update is
elementwise), and the clipping norm is the norm of the whole tree (DTensor
reduces each leaf's partial sums).

``torch.optim.AdamW`` is not this optimizer: it keeps its moments in the
parameter's dtype (bfloat16 for the published configs), applies the decay
as a separate multiply, and has neither the clipping nor the schedule.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.train.tree import leaves, placed_like, shard, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def f32_zeros(t: torch.Tensor) -> torch.Tensor:
    """float32 zeros shaped like ``t``, on its device (a DTensor's: its mesh
    and placements)."""
    return torch.zeros_like(t, dtype=torch.float32)


def init_opt_state(params) -> dict[str, Any]:
    dev = leaves(params)[0].device
    return {
        "m": tree_map(f32_zeros, params),
        "v": tree_map(f32_zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), in float32: linear warm-up,
    then a cosine down to ``min_lr_ratio``."""
    step = step.to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def global_norm(tree) -> torch.Tensor:
    """The float32 norm over every leaf, summed leaf by leaf in tree order."""
    return torch.sqrt(sum(x.to(torch.float32).square().sum() for x in leaves(tree)))


def clip_by_global_norm(grads, max_norm):
    """(``grads`` in float32 scaled to a global norm of at most
    ``max_norm``, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


@torch.no_grad()
def adamw_update(params, opt_state, grads, cfg: OptimizerConfig):
    """One AdamW step. Returns (params, opt_state, metrics): the same dicts,
    their tensors updated in place; metrics ``grad_norm`` and ``lr``."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = opt_state["step"].add_(1)
    lr = lr_at(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1 - torch.pow(cfg.b2, step.to(torch.float32))

    def upd(p, m, v, g):
        p, m, v, g = shard(p), shard(m), shard(v), shard(placed_like(g, p))
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))

    tree_map(upd, params, opt_state["m"], opt_state["v"], grads)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
