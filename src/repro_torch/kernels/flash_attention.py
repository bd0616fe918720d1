"""``flash_attention`` -- causal or full GQA attention with an online softmax.

The CUDA kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention``;
:func:`flash_attention_ref` is its plain-PyTorch version, the counterpart
of ``repro/kernels/ref.py::flash_attention_ref``: dense fp32 attention
built from the port's model layers.  Layout ``(B, L, H, dh)``, as
``repro``'s; the kernel reads it in place.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import check_tensor, on_cpu
from repro_torch.kernels.build import load

__all__ = ["flash_attention", "flash_attention_ref", "HEAD_DIMS"]

HEAD_DIMS = (8, 16, 32, 64, 80, 128)     # the head widths the kernel is built for
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Plain version of :func:`flash_attention`: dense fp32 attention
    (``repro``'s oracle), in v's dtype as ``_gqa_out`` returns it."""
    from repro_torch.models.layers import _gqa_out, _gqa_scores, _mask_bias

    lq, lk = q.shape[1], k.shape[1]
    s = _gqa_scores(q, k) + _mask_bias(
        torch.arange(lq, device=q.device), torch.arange(lk, device=q.device),
        causal=causal, window=0)
    return _gqa_out(torch.softmax(s, dim=-1), v)


def _check_blocks(lq: int, lk: int, block_q: int, block_k: int) -> None:
    """``repro``'s tiling check; the CUDA kernel picks its own tile."""
    block_q, block_k = min(block_q, lq), min(block_k, lk)
    if lq % block_q or lk % block_k:
        raise ValueError(f"pad seq to block size: lq={lq}, lk={lk} with "
                         f"block_q={block_q}, block_k={block_k}")


def flash_attention(
    q: torch.Tensor,   # (B, Lq, Hq, dh)
    k: torch.Tensor,   # (B, Lk, Hkv, dh)
    v: torch.Tensor,   # (B, Lk, Hkv, dh)
    *,
    causal: bool = True,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Fused GQA attention. Returns (B, Lq, Hq, dh) in q's dtype.

    ``block_q`` and ``block_k`` are ``repro``'s tile sizes: they are
    validated (``Lq`` and ``Lk`` must be multiples of them, each capped at
    its length) and choose nothing here.
    """
    _check_blocks(q.shape[1], k.shape[1], block_q, block_k)
    if on_cpu(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal).to(q.dtype)
    b, lq, hq, dh = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q: expected float32 or bfloat16, got {q.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} kv heads")
    check_tensor(q, "q", q.dtype, (b, lq, hq, dh), contiguous=True)
    check_tensor(k, "k", q.dtype, (b, lk, hkv, dh), contiguous=True)
    check_tensor(v, "v", q.dtype, (b, lk, hkv, dh), contiguous=True)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")
    out = torch.empty_like(q)
    fn = load("flash_attention").flash_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, lq, lk, hq, hkv,
             dh, int(q.dtype == torch.bfloat16), int(causal), dh ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {err}")
    if b * lq:
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
