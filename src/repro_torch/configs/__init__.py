"""Assigned-architecture registry: exact configs + reduced smoke configs.

The port's own copy of ``repro.configs`` (pure data; the port imports
nothing of ``repro``), held equal to it field for field by
``tests/test_torch_models.py``.

``get_config(arch)`` returns the full published config; ``get_smoke(arch)``
a reduced same-family config for CPU tests.  ``SHAPES`` defines the four
assigned input shapes; ``cells(arch)`` yields the runnable (arch × shape)
cells with skip reasons for the rest (DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = [
    "qwen3_moe_30b_a3b",
    "grok_1_314b",
    "stablelm_1_6b",
    "qwen1_5_32b",
    "qwen3_32b",
    "tinyllama_1_1b",
    "mamba2_780m",
    "llama_3_2_vision_11b",
    "hymba_1_5b",
    "hubert_xlarge",
]

# Canonical dashed names (CLI) -> module ids.
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def _module(arch: str):
    arch = ALIASES.get(arch, arch)
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke(arch: str):
    return _module(arch).SMOKE


def skip_reason(arch: str, shape: str) -> str | None:
    """None if the (arch, shape) cell runs; else the documented skip."""
    cfg = get_config(arch)
    spec = SHAPES[shape]
    if spec.kind == "decode" and not cfg.causal:
        return "encoder-only: no autoregressive decode step"
    if shape == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return "pure full-attention arch: 500k decode requires sub-quadratic attention"
    return None


def cells(arch: str | None = None):
    """Yield (arch, shape, skip_reason|None) for the 40-cell table."""
    archs = [arch] if arch else ARCH_IDS
    for a in archs:
        for s in SHAPES:
            yield a, s, skip_reason(a, s)
