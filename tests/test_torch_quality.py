"""The port's quality metrics against ``repro``'s: device histograms,
per-part class sizes, balance, reports and trajectories, each equal to
``repro``'s function on the same inputs, and to the host oracles.

The counterparts of ``tests/test_quality.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quality as j_quality
from repro_torch.core.quality import (
    balance_metrics,
    color_histogram_device,
    part_class_sizes,
    quality_report,
    trajectory,
)
from repro_torch.core.validate import color_histogram, is_balanced, num_colors

RNG = np.random.default_rng(7)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cap", [4, 16, 64])
def test_device_histogram_matches_repro_and_host_oracle(cap):
    colors = RNG.integers(-2, 9, size=500).astype(np.int32)
    big = np.concatenate([colors, np.full(7, 40, np.int32)])
    for c in (colors, big):
        dev = color_histogram_device(torch.from_numpy(c), cap)
        assert dev.dtype == torch.int32 and dev.device.type == "cpu"
        _same(dev.numpy(), j_quality.color_histogram_device(jnp.asarray(c), cap))
        # Colors beyond the capacity aggregate into the top bucket: the
        # colored-vertex count is conserved.
        assert int(dev.sum()) == int((c > 0).sum())
    host = color_histogram(np.clip(colors, 0, None), minlength=16)
    host[0] = 0
    if cap == 16:
        _same(color_histogram_device(torch.from_numpy(colors), 16).numpy(),
              host.astype(np.int32))
        assert int(color_histogram_device(torch.from_numpy(big), 16)[15]) == 7


def test_part_class_sizes_match_repro():
    stacked = RNG.integers(0, 6, size=(4, 100)).astype(np.int32)
    per_part = part_class_sizes(torch.from_numpy(stacked), 8)
    assert per_part.shape == (4, 8)
    _same(per_part.numpy(), j_quality.part_class_sizes(jnp.asarray(stacked), 8))
    glob = color_histogram(stacked.reshape(-1), minlength=8)
    glob[0] = 0
    assert (per_part.numpy().sum(axis=0) == glob).all()
    # Capacity below the colors: the top bucket collects them per part.
    _same(part_class_sizes(torch.from_numpy(stacked), 3).numpy(),
          j_quality.part_class_sizes(jnp.asarray(stacked), 3))


@pytest.mark.parametrize("colors", [
    [1, 1, 1, 1, 2, 2, 3, 0, 0],
    [1, 2, 3],
    [0, 0, 0],
    [5, 5, 1, 2, 2, 2, 0, 7],
])
def test_balance_metrics_match_repro(colors):
    hist = color_histogram(np.asarray(colors, np.int32))
    assert balance_metrics(hist) == j_quality.balance_metrics(hist)


def test_balance_metrics_and_is_balanced():
    colors = np.array([1, 1, 1, 1, 2, 2, 3, 0, 0], np.int32)
    mx, mn, mean, balance, skew = balance_metrics(color_histogram(colors))
    assert (mx, mn) == (4, 1)
    assert mean == 7 / 3
    assert balance == 4 / mean and skew == 4.0
    assert not is_balanced(colors, tol=1.25)
    assert is_balanced(colors, tol=2.0)
    assert is_balanced(np.array([1, 2, 3], np.int32))
    assert is_balanced(np.zeros(5, np.int32))
    assert balance_metrics(color_histogram(np.zeros(3, np.int32)))[0] == 0


@pytest.mark.parametrize("stacked_as", [None, "numpy", "tensor"])
def test_quality_report_matches_repro(stacked_as):
    colors = np.array([1, 1, 2, 2, 2, 3, 0], np.int32)
    stacked = colors[:6].reshape(2, 3)
    arg = {None: None, "numpy": stacked, "tensor": torch.from_numpy(stacked)}[stacked_as]
    q = quality_report(colors, stacked_colors=arg)
    want = j_quality.quality_report(
        colors, stacked_colors=None if arg is None else stacked)
    for f in ("n_colors", "n_colored", "n_uncolored", "max_class_size",
              "min_class_size", "mean_class_size", "balance", "skew"):
        assert getattr(q, f) == getattr(want, f), f
    _same(q.histogram, want.histogram)
    assert q.row() == want.row()
    if arg is None:
        assert q.part_class_sizes is None and want.part_class_sizes is None
    else:
        _same(q.part_class_sizes, want.part_class_sizes)
        assert q.part_class_sizes.shape == (2, q.histogram.shape[0])
        assert q.part_class_sizes.sum() == 6
    assert q.n_colors == num_colors(colors) == 3
    assert q.n_colored == 6 and q.n_uncolored == 1
    assert "colors=3" in q.row() and "balance=" in q.row()


@pytest.mark.parametrize("counts,comm", [
    ([12, 10, 9], None), ([5], []), ([12, 9], [100, 80]), ([7, 7], [3])])
def test_trajectory_matches_repro(counts, comm):
    assert trajectory(counts, comm) == j_quality.trajectory(counts, comm)


def test_trajectory_rendering():
    assert trajectory([12, 10, 9]) == "12>10>9"
    assert trajectory([5], []) == "5;comm="
    assert trajectory([12, 9], [100, 80]) == "12>9;comm=100+80"
