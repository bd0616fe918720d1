"""Int8 gradient compression with error feedback.

The counterpart of ``repro/train/compression.py``: per-tensor symmetric
int8 quantization of the gradients, with an error-feedback accumulator
(Seide et al. / EF-SGD) that carries each step's quantization residual into
the next, so the long-run gradient is unbiased.  On one card the int8
round trip models what would cross a data-parallel all-reduce.
``torch.round`` rounds half to even, as ``jnp.round`` does, so on the same
inputs the results are ``repro``'s exactly.  On a mesh each scale is the
maximum over the whole leaf, as ``repro`` computes it under GSPMD: DTensor
reduces the shards' maxima.
"""
from __future__ import annotations

import torch

from repro_torch.train.optimizer import f32_zeros
from repro_torch.train.tree import tree_map


def init_state(params):
    return tree_map(f32_zeros, params)


def _quantize(g):
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q, scale):
    return q.to(torch.float32) * scale


@torch.no_grad()
def compress_decompress(grads, err_state):
    """Quantize grads (+ error feedback); returns (grads_hat, new_err_state)."""
    def one(g, e):
        g = g.to(torch.float32) + e
        q, scale = _quantize(g)
        g_hat = _dequantize(q, scale)
        return g_hat, g - g_hat

    out = tree_map(one, grads, err_state)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)
