"""Train-step builder: loss → grad → (compress) → clip → AdamW.

The counterpart of ``repro/train/step.py``: ``make_train_step`` returns
``train_step(params, opt_state, batch[, comp_state])`` with ``repro``'s
results and metric keys.  Gradients come from ``torch.autograd.grad`` of
``lm_loss``; ``microbatches > 1`` splits the batch's leading axis and
accumulates the gradients into float32 zeros (``repro``'s ``lax.scan``);
``compress_grads`` sends them through the int8 round trip with error
feedback before the update.  Metrics are device scalars: reading them is
the caller's one host sync a step.  On a mesh (DTensor leaves) each
gradient is redistributed to its parameter's placements, so the sums,
the optimizer state and the update stay shard by shard.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import lm_loss
from repro_torch.train import compression
from repro_torch.train.optimizer import OptimizerConfig, adamw_update, f32_zeros
from repro_torch.train.tree import flatten, map_with_path, placed_like, shard, tree_map


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: OptimizerConfig,
    *,
    microbatches: int = 1,
    compress_grads: bool = False,
):
    """Returns train_step(params, opt_state, batch[, comp_state]) -> ...; the
    parameters and the state are updated in place and returned."""

    def grads_of(params, batch):
        flat = flatten(params)
        for t in flat.values():
            t.requires_grad_(True)
        loss, metrics = lm_loss(params, cfg, batch)
        grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True,
                                    materialize_grads=True)
        by_path = {k: placed_like(g, flat[k]) for k, g in zip(flat, grads)}
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                map_with_path(lambda path, _: by_path[path], params))

    def accumulate(params, batch):
        if microbatches == 1:
            return grads_of(params, batch)
        # Split the batch's leading axis into microbatches and loop.
        def resplit(x, i):
            if x is None:
                return None
            b = x.shape[0] // microbatches
            return x[i * b:(i + 1) * b]

        loss = torch.zeros((), dtype=torch.float32, device=batch["labels"].device)
        grads = tree_map(f32_zeros, params)
        for i in range(microbatches):
            mloss, _, mgrads = grads_of(params, {k: resplit(v, i) for k, v in batch.items()})
            tree_map(lambda acc, g: shard(acc).add_(shard(g)), grads, mgrads)
            loss = loss + mloss
        scale = 1.0 / microbatches
        return loss * scale, {}, tree_map(lambda g: g * scale, grads)

    if compress_grads:
        def train_step(params, opt_state, batch, comp_state):
            loss, metrics, grads = accumulate(params, batch)
            grads, comp_state = compression.compress_decompress(grads, comp_state)
            params, opt_state, opt_metrics = adamw_update(params, opt_state, grads, opt_cfg)
            return params, opt_state, comp_state, {"loss": loss, **metrics, **opt_metrics}
    else:
        def train_step(params, opt_state, batch):
            loss, metrics, grads = accumulate(params, batch)
            params, opt_state, opt_metrics = adamw_update(params, opt_state, grads, opt_cfg)
            return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step

