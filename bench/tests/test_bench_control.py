"""The comparison that decides ``correct`` fails where it must: the control
(the reference with its conflict rounds left out, in the program's place)
on every cell, and a whole run with the timed path broken underneath."""
import time

import numpy as np
import pytest
import torch

from bench import harness
from bench.control import control_checks
from bench.tests._cells import CELLS, cell, mix

TINY = {"graph": {"dims": [12, 8, 8]}}  # 2 x-planes a part of 6


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 9])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_is_not_correct(name, seed):
    checks = control_checks(cell(name), seed, "cpu", overrides=TINY, mix=mix(name))
    assert not all(v <= lim for v, lim in checks.values())
    assert checks["improper"][0] > 0 and checks["colors_differ"][0] > 0


def _state_unchanged(monkeypatch):
    """A round that returns its state unchanged and finds no conflict."""
    from repro_torch.core.backend import CudaFusedBackend

    def round_(self, st, colors, ghost, *, problem, recolor_degrees):
        zero = torch.zeros(colors.shape[0], dtype=torch.int32)
        return (colors, torch.zeros_like(colors, dtype=torch.bool),
                torch.zeros_like(ghost, dtype=torch.bool), zero)

    monkeypatch.setattr(CudaFusedBackend, "round", round_)


def _half_left_out(monkeypatch):
    """The colors of half of the parts left out of the gathered answer (the
    plan's own route planning, which colors one part, left alone)."""
    from repro_torch.core.plan import ColoringPlan

    real = ColoringPlan._result

    def result(self, colors, *args):
        if colors.shape[0] > 1:
            colors = colors.clone()
            colors[colors.shape[0] // 2:] = 0
        return real(self, colors, *args)

    monkeypatch.setattr(ColoringPlan, "_result", result)


def _exchange_left_out(monkeypatch):
    """The exchange returns no ghost colors (nothing crossed between parts)."""
    from repro_torch.core.exchange import SparseDeltaExchange

    real = SparseDeltaExchange.stacked

    def stacked(self, st, colors, state):
        ghost, nbytes, state = real(self, st, colors, state)
        return torch.zeros_like(ghost), nbytes, state

    monkeypatch.setattr(SparseDeltaExchange, "stacked", stacked)


def _answer_altered(monkeypatch):
    """One vertex's color changed where the answer is produced."""
    from repro_torch.core.plan import ColoringPlan

    real = ColoringPlan._result

    def result(self, *args):
        res = real(self, *args)
        if self.n_parts > 1:
            res.colors = res.colors.copy()
            res.colors[np.argmax(res.colors)] += 1
        return res

    monkeypatch.setattr(ColoringPlan, "_result", result)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out, _exchange_left_out,
                                   _answer_altered])
@pytest.mark.parametrize("name", ["hex252_d1.cold", "hex252_d2.cold", "hex252_d1.timesteps"])
def test_broken_program_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    line = harness.run_cell(cell(name), seed=2**31 + 1, seconds=0.3,
                            trace=False, device="cpu", t_start=time.perf_counter(),
                            overrides=TINY, mix=mix(name))
    assert line["correct"] is False, line["checks"]


# The four-card cell's ranks 1.. are spawned processes: the fault reaches
# them through a ``sitecustomize`` module on their ``PYTHONPATH``, and rank 0
# (this process) through ``monkeypatch``.  Each plants with ``setattr``.
GROUP_FAULTS = {
    "exchange_left_out": """
def plant(setattr):
    from repro_torch.core.exchange import SparseDeltaExchange
    real = SparseDeltaExchange.device
    def device(self, st, colors, state, **kw):
        ghost, nbytes, state = real(self, st, colors, state, **kw)
        return ghost * 0, nbytes, state
    setattr(SparseDeltaExchange, "device", device)
""",
    "state_unchanged": """
def plant(setattr):
    import torch
    from repro_torch.core.backend import CudaFusedBackend
    def round_(self, st, colors, ghost, *, problem, recolor_degrees):
        return (colors, torch.zeros_like(colors, dtype=torch.bool),
                torch.zeros_like(ghost, dtype=torch.bool),
                torch.zeros(colors.shape[0], dtype=torch.int32))
    setattr(CudaFusedBackend, "round", round_)
""",
}


@pytest.mark.parametrize("fault", sorted(GROUP_FAULTS))
def test_broken_group_is_not_correct(fault, tmp_path, monkeypatch):
    import os
    import sys

    code = GROUP_FAULTS[fault]
    (tmp_path / "sitecustomize.py").write_text(
        f"import sys\nsys.path.insert(0, {str(harness.ROOT / 'src')!r})\n{code}\n"
        "plant(setattr)\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path)] + [p for p in sys.path if p]))
    namespace = {}
    exec(code, namespace)
    namespace["plant"](monkeypatch.setattr)
    line = harness.run_cell(cell("hex252_d1_x4.cold"), seed=2**31 + 1,
                            seconds=0.3, trace=False, device="cpu",
                            t_start=time.perf_counter(), overrides=TINY)
    assert line["correct"] is False, line["checks"]
