"""Deterministic synthetic token pipeline (restart/skip-exact).

The port's own copy of ``repro/data/pipeline.py`` (numpy only; the port
imports nothing of ``repro``): ``batch_at(step)`` gives the same bytes.

Batches are a pure function of (seed, step), so restart-from-checkpoint
reproduces the exact stream with no state files, and the straggler policy
"skip batch k" is exact.  Each step draws a Zipf-ish token distribution so
embedding-gather patterns resemble natural text rather than uniform noise.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    frontend_dim: int = 0       # audio stub features
    vision_seq: int = 0         # vlm stub embeddings
    d_model: int = 0

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 32) ^ step)
        shape = (self.global_batch, self.seq_len)
        ranks = rng.zipf(self.zipf_a, size=shape)
        tokens = np.minimum(ranks - 1, self.vocab_size - 1).astype(np.int32)
        batch = {"labels": tokens}
        if self.frontend_dim:
            batch["tokens"] = None
            batch["frames"] = rng.standard_normal(
                (self.global_batch, self.seq_len, self.frontend_dim), dtype=np.float32)
        else:
            batch["tokens"] = tokens
        if self.vision_seq:
            batch["img"] = rng.standard_normal(
                (self.global_batch, self.vision_seq, self.d_model), dtype=np.float32)
        return batch

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
