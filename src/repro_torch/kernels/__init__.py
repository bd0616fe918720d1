"""Hand-written CUDA kernels for Hopper (sm_90a): the coloring hot spots
and the model's attention.

* ``vb_bit``       -- windowed forbidden-bitmask color assignment
* ``conflict``     -- Algorithm-4 conflict detection over ELL rows
* ``d2_forbidden`` -- net-based two-hop (distance-2) color assignment over
  a list of the rows to color
* ``collision``    -- the Alg-4 speculative-collision test of the local
  fixed points over a list of the active rows, committed into the table
* ``fused_round``  -- one whole round (optional pair scatter into the
  ghosts, detect, zero losers, recolor fixed point) in one cooperative
  launch
* ``pair_scatter`` -- ``(slot, value)`` pairs stored into slot tables (the
  receive step of the sparse exchanges), one launch of thread-block
  clusters
* ``flash_attention`` -- causal or full GQA attention with an online
  softmax (``repro``'s ``kernels.ops.flash_attention``)

Each kernel ships ``csrc/<name>.cu``, a wrapper in ``kernels/<name>.py``
(``pair_scatter``: ``kernels/scatter.py``, as in ``repro``)
with its plain-PyTorch version beside it, and a launch counter on the
wrapper.  A wrapper takes the plain version only for tensors that lie on
the CPU; for CUDA tensors it launches the kernel or raises.
``csrc/coloring.cuh`` holds the device math they share (``gid_hash``, the
Alg-4 loser rule, the window bit and pick), so they agree bit for bit.
``kernels/ops.py`` runs the local fixed points on ``vb_bit``,
``d2_forbidden`` and ``collision``.
``kernels/build.py`` compiles the sources with ``nvcc`` at first use.
"""
from __future__ import annotations

import torch

__all__ = ["on_cpu", "check_tensor"]


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when all lie on one
    CUDA device; raises for any other mix."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return False
    raise ValueError("kernel inputs must all lie on the CPU or all on one "
                     f"CUDA device, got {sorted(str(d) for d in devices)}")


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: tuple[int, ...], *, contiguous: bool = False) -> int:
    """Check one kernel argument; returns its stride over the part axis.

    Every argument must have a contiguous last axis; ``contiguous``
    demands the whole array be contiguous.
    """
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: last axis must be contiguous")
    return t.stride(0)
