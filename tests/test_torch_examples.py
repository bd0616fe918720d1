"""The port's coloring examples (``examples/*_torch.py``) on the CPU,
asserting what their ``repro`` originals assert."""
from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.core import is_proper_d1
from repro_torch.graph.generators import hex_mesh

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One thread, as the suite's workers share the cores: at these sizes
    more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(["--device", "cpu"])


def test_quickstart_torch():
    """D1 converges properly; ``delta`` and ``cuda_fused`` give the same
    coloring in the same rounds as ``all_gather`` on ``reference``."""
    out = run_example("quickstart_torch")
    res = out["d1"]
    assert res.converged and is_proper_d1(hex_mesh(16, 12, 12), res.colors)
    for other in (out["delta"], out["cuda_fused"]):
        np.testing.assert_array_equal(other.colors, res.colors)
        assert other.rounds == res.rounds
    assert out["cuda_fused"].backend == "cuda_fused"
    assert all(r.converged for r in out["rmat"]) and out["greedy"] > 0


def test_color_jacobian_torch():
    """A proper PD2 coloring whose seed-matrix probes recover every
    nonzero of the Jacobian."""
    out = run_example("color_jacobian_torch")
    assert out["pd2"].converged
    np.testing.assert_allclose(out["recovered"], out["J"], atol=1e-12)
    assert len(out["groups"]) < out["J"].shape[1]
