"""The port's comparison points against ``repro``'s: the serial greedy
oracle (byte-equal), the Bozdağ/Zoltan batched-boundary baseline and
Jones-Plassmann (equal in every field of the result), and the CLI flags
that reach them and the reduction (same result lines as ``repro``'s CLI).

Both packages get the same ``PartitionedGraph``; the port runs on the CPU.
"""
import sys

import numpy as np
import pytest
import torch

from repro.core import greedy as j_greedy
from repro.core.baseline import color_baseline as j_baseline
from repro.core.jones_plassmann import color_jones_plassmann as j_jp
from repro.graph import generators as j_gen
from repro.graph.partition import partition_graph as j_partition
from repro.launch import color as j_cli
from repro_torch.core import greedy as t_greedy
from repro_torch.core import plan as plan_mod
from repro_torch.core.baseline import color_baseline
from repro_torch.core.distributed import color_distributed
from repro_torch.core.jones_plassmann import color_jones_plassmann
from repro_torch.core.validate import is_proper_d1, is_proper_d2
from repro_torch.graph import generators as t_gen
from repro_torch.graph.partition import partition_graph as t_partition
from repro_torch.launch import color as t_cli

GRAPHS = {
    "hex": ("hex_mesh", (6, 4, 4), {}),
    "grid": ("grid_2d", (12, 10), {}),
    "rmat": ("rmat", (8, 6), {"seed": 3}),
    "myc": ("mycielskian", (7,), {}),
    "er": ("erdos_renyi", (150, 5.0), {"seed": 4}),
    "bip": ("bipartite_random", (30, 20, 3), {"seed": 1}),
}
RESULT_FIELDS = ("rounds", "converged", "n_colors", "total_conflicts",
                 "comm_bytes_per_round", "problem", "n_parts", "backend",
                 "exchange", "comm_bytes_total", "comm_bytes_by_round",
                 "comm_bytes_by_level")


def _pair(gname):
    fn, args, kw = GRAPHS[gname]
    return getattr(j_gen, fn)(*args, **kw), getattr(t_gen, fn)(*args, **kw)


def assert_same_result(got, want):
    assert got.colors.dtype == want.colors.dtype
    np.testing.assert_array_equal(got.colors, want.colors)
    for f in RESULT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("gname", list(GRAPHS))
@pytest.mark.parametrize("order", ["natural", "largest_first", "smallest_last"])
def test_greedy_byte_equal(gname, order):
    jg, tg = _pair(gname)
    np.testing.assert_array_equal(t_greedy.vertex_order(tg, order),
                                  j_greedy.vertex_order(jg, order))
    for fn in ("greedy_d1", "greedy_d2", "greedy_pd2"):
        got, want = getattr(t_greedy, fn)(tg, order), getattr(j_greedy, fn)(jg, order)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), fn
    assert is_proper_d1(tg, t_greedy.greedy_d1(tg, order))
    assert is_proper_d2(tg, t_greedy.greedy_d2(tg, order))
    with pytest.raises(ValueError, match="unknown order"):
        t_greedy.vertex_order(tg, "random")


@pytest.mark.parametrize("spec,parts,strategy,problem,kw", [
    (("rmat", (9, 8), {"seed": 4}), 8, "edge_balanced", "d1", {}),
    (("hex_mesh", (6, 4, 4), {}), 3, "block", "d1",
     {"recolor_degrees": True, "n_batches": 3}),
    (("hex_mesh", (6, 4, 4), {}), 3, "block", "d2", {}),
    (("mycielskian", (7,), {}), 4, "edge_balanced", "d1", {"max_rounds": 9}),
])
def test_color_baseline_matches_repro(spec, parts, strategy, problem, kw):
    fn, args, gkw = spec
    jg, tg = getattr(j_gen, fn)(*args, **gkw), getattr(t_gen, fn)(*args, **gkw)
    l2 = problem != "d1"
    jpg = j_partition(jg, parts, strategy=strategy, second_layer=l2)
    tpg = t_partition(tg, parts, strategy=strategy, second_layer=l2)
    got = color_baseline(tpg, problem=problem, device="cpu", **kw)
    assert_same_result(got, j_baseline(jpg, problem=problem, **kw))
    assert got.problem == f"{problem}-baseline"
    assert got.comm_bytes_per_round == parts * tpg.send_width * 4
    # The static tables come from the plan layer's host-state cache.
    assert (tpg.signature, problem) in plan_mod._STATE_CACHE
    if got.converged:
        assert (is_proper_d2 if l2 else is_proper_d1)(tg, got.colors)


@pytest.mark.parametrize("spec,parts", [
    (("hex_mesh", (8, 8, 8), {}), 4),
    (("rmat", (9, 6), {"seed": 2}), 4),
    (("grid_2d", (16, 16), {}), 1),
])
def test_jones_plassmann_matches_repro(spec, parts):
    fn, args, gkw = spec
    jg, tg = getattr(j_gen, fn)(*args, **gkw), getattr(t_gen, fn)(*args, **gkw)
    jpg = j_partition(jg, parts, strategy="edge_balanced")
    tpg = t_partition(tg, parts, strategy="edge_balanced")
    got = color_jones_plassmann(tpg, device="cpu")
    assert_same_result(got, j_jp(jpg))
    assert got.converged and got.total_conflicts == 0
    assert is_proper_d1(tg, got.colors)
    spec_run = color_distributed(tpg, cache=False, device="cpu")
    if parts > 1:
        assert got.rounds > spec_run.rounds      # the paper's §2.3 rationale
    # A round budget that stops JP early stops it where repro stops.
    assert_same_result(color_jones_plassmann(tpg, max_rounds=2, device="cpu"),
                       j_jp(jpg, max_rounds=2))


def test_comparison_points_raise_without_a_card(monkeypatch):
    tpg = t_partition(t_gen.hex_mesh(4, 4, 4), 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        color_baseline(tpg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        color_jones_plassmann(tpg)


# ---------------------------------------------------------------------------
# The CLI: the port's result lines equal repro's for the same graph.
# ---------------------------------------------------------------------------

def _fields(out: str) -> dict:
    """The ``k=v`` fields of the CLI's result lines, less time, devices and
    the backend (``repro`` runs its ``reference``, the port ``cuda_fused``)."""
    fields = {}
    for line in out.splitlines():
        if line.startswith("[color] reduce ") or " proper=" in line:
            key = line.split()[1]
            words = [w for w in line.split()[2:]
                     if not w.startswith(("time=", "(device", "(devices", "backend="))]
            fields[key] = words
    return fields


@pytest.mark.parametrize("argv", [
    ["--graph", "myc:8", "--parts", "4", "--strategy", "edge_balanced",
     "--reduce-passes", "2"],
    ["--graph", "hex:8,6,6", "--parts", "3", "--problem", "d2",
     "--exchange", "delta", "--reduce-passes", "3", "--reduce-order", "largest_first"],
    ["--graph", "rmat:8,6", "--parts", "4", "--baseline", "--reduce-passes", "1"],
    ["--graph", "hex:8,6,6", "--parts", "3", "--repeat", "3", "--engine", "simulate"],
])
def test_cli_prints_what_repro_prints(argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["color"] + argv)
    j_cli.main()
    want = capsys.readouterr().out
    t_cli.main(argv + ["--device", "cpu", "--backend", "cuda_fused"])
    got = capsys.readouterr().out
    assert _fields(got) == _fields(want) and _fields(got)
    assert "proper=True" in got
    if "--repeat" in argv:
        assert "compile_ms=" in got and "warm_ms=" in got and "repeat=3" in got
    if "--baseline" in argv:
        assert "d1-baseline" in got and "backend=reference" in got
    else:
        assert "backend=cuda_fused" in got
