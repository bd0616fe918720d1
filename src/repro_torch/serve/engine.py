"""Minimal batched serving engine over the model's cache machinery.

The counterpart of ``repro/serve/engine.py``: a fixed batch of slots,
prompts left-padded with token 0 into one length bucket, one prefill, then
greedy decode steps to the longest budget.  As in ``repro``, no padding
mask is passed: the pad tokens are attended.  The decode loop runs under
``torch.inference_mode()`` with the cache and its length on the device;
the host reads the step's tokens in one bulk device-to-host copy per step.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.plan import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import decode_step, prefill

__all__ = ["ServeEngine", "pad_prompts"]


def pad_prompts(prompts: list[np.ndarray], batch: int) -> np.ndarray:
    """The ``(batch, longest prompt)`` int32 token block the engine prefills:
    each prompt left-padded with token 0, unused slots all 0."""
    lp = max(len(p) for p in prompts)
    toks = np.zeros((batch, lp), np.int32)
    for i, p in enumerate(prompts):
        toks[i, lp - len(p):] = p  # left-pad into the bucket
    return toks


class ServeEngine:
    """``params`` lie on ``device``, ``"cuda"`` unless the caller asks for
    the CPU; without a card the default raises (``device="cpu"`` serves on
    the CPU)."""

    def __init__(self, cfg: ModelConfig, params, *, batch: int, max_len: int,
                 device="cuda"):
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.device = resolve_device(device)

    def generate(self, prompts: list[np.ndarray],
                 max_new_tokens: int | list[int],
                 *, greedy: bool = True) -> list[list[int]]:
        """Batch-generate; prompts padded to a common length bucket.

        ``max_new_tokens`` is one shared budget or a per-request list.
        Slot semantics: the decode loop runs to the *longest* budget (the
        batch shares one step), so slots whose budget is exhausted keep
        decoding as batch padding, but their tokens are not emitted: each
        request's output stops at its own ``max_new_tokens``.
        """
        limits = ([max_new_tokens] * len(prompts)
                  if isinstance(max_new_tokens, int) else list(max_new_tokens))
        if not len(limits) == len(prompts) <= self.batch:
            raise ValueError(f"{len(prompts)} prompts and {len(limits)} budgets "
                             f"for a batch of {self.batch}")
        steps = max(limits)
        toks = pad_prompts(prompts, self.batch)
        outs: list[list[int]] = [[] for _ in prompts]
        with torch.inference_mode():
            logits, cache = prefill(self.params, self.cfg,
                                    torch.from_numpy(toks).to(self.device),
                                    max_len=toks.shape[1] + steps)
            cur = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
            for t in range(steps):
                step_toks = cur[:, 0].cpu().numpy()
                for i, lim in enumerate(limits):
                    if t < lim:
                        outs[i].append(int(step_toks[i]))
                logits, cache = decode_step(self.params, self.cfg, cur, cache)
                cur = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        return outs
