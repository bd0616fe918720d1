"""The port's roofline (``repro_torch/roofline/analysis.py``) against
``repro``'s (``repro/roofline/analysis.py``).

The formulas are held equal on the same totals, configs and shapes.  The
payload convention is held, collective by collective, against ``repro``'s
parser on HLO text of the same per-device shapes.  The mini cell (TinyLlama
SMOKE, ``train_4k`` cut to 8 x 64, as ``repro``'s mini dry run cuts it) runs
on ``(1, 1)`` and ``(2, 2)`` meshes on both sides: the port's on a fake
process group of 4 ranks in one subprocess, ``repro``'s through
``repro.launch.dryrun.run_cell`` on an Auto-axes ``jax.sharding.Mesh`` of 8
forced CPU devices in another (``repro.launch.mesh.make_mesh``'s meshes
cannot be lowered on jax 0.9, ROADMAP.md §3).  Both subprocesses run at
once.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

import repro.configs as jcfgs
import repro.roofline.analysis as jroof
import repro_torch.configs as tcfgs
import repro_torch.roofline.analysis as troof

MESHES = ("1x1", "2x2")
SUBPROCESS_LIMIT_S = 300

PORT_SIDE = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.distributed.nn.functional import all_to_all_single
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from repro_torch import configs
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import ShapeMesh
from repro_torch.roofline.analysis import StepCounter, fake_mesh, fake_process_group

META = torch.device("meta")
out = {"redistribute": {}, "cells": {}}
specs.SHAPES["train_4k"] = configs.ShapeSpec("train_4k", 64, 8, "train")
with fake_process_group(4):
    mesh = fake_mesh((2, 2), ("data", "model"))
    x = torch.empty((64, 32), device=META)
    cases = {
        "Shard(0)->Replicate": (distribute_tensor(x, mesh, [Shard(0), Replicate()],
                                                  src_data_rank=None), [Replicate()] * 2),
        "Partial->Replicate": (DTensor.from_local(x, mesh, [Partial(), Replicate()]),
                               [Replicate()] * 2),
        "Partial->Shard": (DTensor.from_local(x, mesh, [Partial(), Replicate()]),
                           [Shard(0), Replicate()]),
    }
    for name, (t, want) in cases.items():
        c = StepCounter()
        with c:
            t.redistribute(mesh, want)
        out["redistribute"][name] = (c.totals(), list(t.to_local().shape))
    c = StepCounter()
    y = torch.empty((8, 16), device=META)
    with c:
        all_to_all_single(torch.empty_like(y), y, group=mesh.get_group("model"))
    out["redistribute"]["all_to_all_single"] = (c.totals(), list(y.shape))
    cfg = configs.get_smoke("tinyllama_1_1b")
    for shape in ((1, 1), (2, 2)):
        rec = dryrun.run_cell("tinyllama_1_1b", "train_4k", ShapeMesh(("data", "model"), shape),
                              cfg=cfg, verbose=False)
        out["cells"]["x".join(map(str, shape))] = rec
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""

REPRO_SIDE = r"""
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import numpy as np
from jax.sharding import Mesh
from repro import configs
from repro.launch import dryrun, specs

specs.SHAPES["train_4k"] = configs.ShapeSpec("train_4k", 64, 8, "train")
cfg = configs.get_smoke("tinyllama_1_1b")
out = {}
for shape in ((1, 1), (2, 2)):
    mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape), ("data", "model"))
    rec = dryrun.run_cell("tinyllama_1_1b", "train_4k", mesh, cfg=cfg, verbose=False)
    out["x".join(map(str, shape))] = rec
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(the port's records, repro's records), from two subprocesses run at
    once."""
    tmp = tmp_path_factory.mktemp("roofline")
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [src, *filter(None, [os.environ.get("PYTHONPATH")])]),
        "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    procs = {side: subprocess.Popen([sys.executable, "-c", script, str(tmp / f"{side}.json")],
                                    env=env)
             for side, script in (("port", PORT_SIDE), ("repro", REPRO_SIDE))}
    for side, p in procs.items():
        try:
            assert p.wait(timeout=SUBPROCESS_LIMIT_S) == 0, f"the {side} side failed"
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
    return tuple(json.loads((tmp / f"{side}.json").read_text()) for side in ("port", "repro"))


@pytest.mark.parametrize("arch", tcfgs.ARCH_IDS)
def test_roofline_terms_and_model_flops_match_repro(arch):
    """Each shape's model FLOPs equal repro's for the same config, and each
    roofline term times its own constant equals repro's term times its
    constant (the card's constants in place of the TPU's)."""
    tcfg, jcfg = tcfgs.get_config(arch), jcfgs.get_config(arch)
    for name, spec in tcfgs.SHAPES.items():
        jspec = jcfgs.SHAPES[name]
        for backward in (False, True):
            assert troof.model_flops(tcfg, spec, backward=backward) == jroof.model_flops(
                jcfg, jspec, backward=backward)
        totals = {"hlo_flops_per_dev": 3.0e15 * spec.seq_len,
                  "hlo_bytes_per_dev": 7.0e12 * spec.global_batch,
                  "collective_total_per_dev": 5.0e11 * (1 + (spec.kind == "train"))}
        got, want = troof.roofline_terms(totals), jroof.roofline_terms(totals)
        for term, tc, jc in (("compute_s", troof.PEAK_FLOPS, jroof.PEAK_FLOPS),
                             ("memory_s", troof.HBM_BW, jroof.HBM_BW),
                             ("collective_s", troof.LINK_BW, jroof.ICI_BW)):
            assert got[term] * tc == pytest.approx(want[term] * jc, rel=1e-12)
        bound = max(got[t] for t in ("compute_s", "memory_s", "collective_s"))
        assert got["roofline_fraction"] == got["compute_s"] / bound
        assert got["dominant"] + "_s" == max(("compute_s", "memory_s", "collective_s"),
                                             key=got.get)


def _hlo(op: str, in_shape, out_shape) -> str:
    """An HLO module of one collective of f32 operands, for repro's parser."""
    dims = lambda s: ",".join(map(str, s))  # noqa: E731
    return (f"HloModule m\n\nENTRY %main (a: f32[{dims(in_shape)}]) -> f32[{dims(out_shape)}] {{\n"
            f"  %a = f32[{dims(in_shape)}]{{1,0}} parameter(0)\n"
            f"  ROOT %c = f32[{dims(out_shape)}]{{1,0}} {op}(%a), replica_groups={{}}\n}}\n")


# (case, HLO op, (operand, output) shapes from the local operand's shape).
CONVENTION = (
    ("Shard(0)->Replicate", "all-gather", lambda s: (s, [s[0] * 2, s[1]])),
    ("Partial->Replicate", "all-reduce", lambda s: (s, s)),
    ("Partial->Shard", "reduce-scatter", lambda s: (s, [s[0] // 2, s[1]])),
    ("all_to_all_single", "all-to-all", lambda s: (s, s)),
)


@pytest.mark.parametrize("case,op,shapes", CONVENTION, ids=[c[0] for c in CONVENTION])
def test_payload_convention_on_single_redistributions(sides, case, op, shapes):
    """On a fake (2, 2) mesh, one redistribution (or one all_to_all_single on
    the model axis) counts one collective of its kind, whose bytes are
    exactly what repro's parser counts for that collective at the same
    per-device shapes (all-gather: output; all-reduce: 2x operand;
    reduce-scatter, all-to-all: operand)."""
    port, _ = sides
    totals, shape = port["redistribute"][case]
    in_shape, out_shape = shapes(shape)
    want = jroof.hlo_totals(_hlo(op, in_shape, out_shape))
    assert totals["collective_bytes_per_dev"] == want["collective_bytes_per_dev"]
    assert totals["collective_total_per_dev"] == want["collective_total_per_dev"]
    assert totals["collective_calls_per_dev"] == {op: 1}
    assert totals["hlo_flops_per_dev"] == 0


@pytest.mark.parametrize("mesh", MESHES)
def test_mini_cell_flops_match_repro(sides, mesh):
    """The mini cell's per-device FLOPs equal repro's hlo_flops_per_dev
    exactly (tolerance 0): the same products at the same local shapes,
    forward and backward, the attention's products included (the port runs
    each rank's attention on its own heads, as the partitioner does)."""
    port, repro = sides
    assert port["cells"][mesh]["hlo_flops_per_dev"] == repro[mesh]["hlo_flops_per_dev"]
    assert port["cells"][mesh]["hlo_flops_per_dev"] > 0


def test_mini_cell_splits_the_work_in_four(sides):
    """On (2, 2) each device does exactly a quarter of the (1, 1) products."""
    port, _ = sides
    cells = port["cells"]
    assert cells["2x2"]["hlo_flops_per_dev"] * 4 == cells["1x1"]["hlo_flops_per_dev"]
    assert cells["2x2"]["chips"] == 4 and cells["1x1"]["chips"] == 1


@pytest.mark.parametrize("mesh", MESHES)
def test_mini_cell_argument_bytes_match_repro(sides, mesh):
    """Each device's argument bytes (parameters, m, v, the step, the batch)
    equal repro's memory_analysis: 1,826,564 and 458,628."""
    port, repro = sides
    assert port["cells"][mesh]["argument_size_in_bytes"] == repro[mesh]["argument_size_in_bytes"]
    assert port["cells"][mesh]["param_bytes"] * 3 < port["cells"][mesh]["argument_size_in_bytes"]


@pytest.mark.parametrize("mesh", MESHES)
def test_mini_cell_collectives(sides, mesh):
    """No collective on (1, 1), as repro reports; on (2, 2) all-gathers,
    all-reduces and reduce-scatters of more than 0 bytes (XLA's partitioner
    chooses other collectives: the bytes are not held equal)."""
    port, repro = sides
    rec = port["cells"][mesh]
    if mesh == "1x1":
        assert rec["collective_bytes_per_dev"] == repro[mesh]["collective_bytes_per_dev"] == {}
        assert rec["collective_total_per_dev"] == 0
    else:
        assert rec["collective_total_per_dev"] > 0 and repro[mesh]["collective_total_per_dev"] > 0
        assert set(rec["collective_bytes_per_dev"]) >= {"all-gather", "all-reduce",
                                                         "reduce-scatter"}
        assert all(v > 0 for v in rec["collective_bytes_per_dev"].values())
        assert rec["collective_s"] > 0


def test_mini_cell_peak_memory(sides):
    """The peak of live bytes: at least the arguments on each mesh, lower on
    (2, 2) than on (1, 1); temp = peak less the arguments."""
    port, _ = sides
    cells = port["cells"]
    for rec in cells.values():
        assert rec["peak_memory_in_bytes"] >= rec["argument_size_in_bytes"]
        assert rec["temp_size_in_bytes"] == (rec["peak_memory_in_bytes"]
                                             - rec["argument_size_in_bytes"])
        assert rec["output_size_in_bytes"] > 0
    assert cells["2x2"]["peak_memory_in_bytes"] < cells["1x1"]["peak_memory_in_bytes"]


@pytest.mark.parametrize("mesh", MESHES)
def test_mini_cell_record_keys(sides, mesh):
    """The record has repro's keys (build_s and run_s in place of lower_s and
    compile_s), and the useful-FLOPs ratio of the cell's own config."""
    port, repro = sides
    rec = port["cells"][mesh]
    skip = {"lower_s", "compile_s"}
    assert set(repro[mesh]) - skip <= set(rec)
    assert {"build_s", "run_s", "params", "param_bytes"} <= set(rec)
    cfg = tcfgs.get_smoke("tinyllama_1_1b")
    spec = tcfgs.ShapeSpec("train_4k", 64, 8, "train")
    mf = troof.model_flops(cfg, spec, backward=True)
    assert rec["model_flops_global"] == mf
    assert rec["useful_flops_ratio"] == mf / rec["chips"] / rec["hlo_flops_per_dev"]


def test_the_fake_group_refuses_a_second_group():
    """The fake group needs a process of its own, and run_cell and fake_mesh
    refuse to run outside one."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import ShapeMesh

    with pytest.raises(RuntimeError, match="fake process group"):
        dryrun.run_cell("tinyllama_1_1b", "train_4k", ShapeMesh(("data", "model"), (1, 1)))
    with pytest.raises(RuntimeError, match="fake default group"):
        troof.fake_mesh((1, 1), ("data", "model"))
