"""Dry run of every (arch × shape × mesh) cell: the counterpart of
``repro/launch/dryrun.py``.

For each runnable cell, with no device memory and no data moved:
  * the cell's step (``launch/specs.py``) with its arguments placed on a
    ``DeviceMesh`` as ``train_loop(mesh=...)`` places them, meta DTensors
    on a fake process group that holds the mesh's ranks;
  * the step runs once, as rank 0, under the cell's activation policy and
    ``roofline/analysis.py``'s counter: rank 0's FLOPs, bytes, collective
    bytes by kind, the three roofline terms, and its argument, output and
    peak bytes (an eager program's live tensors, where ``repro`` reads the
    compiler's ``memory_analysis()``).
``repro``'s ``flops`` and ``bytes_accessed`` come from XLA's
``cost_analysis()``; the port has one count, so they equal
``hlo_flops_per_dev`` and ``hlo_bytes_per_dev``.

A process has one default group, so the CLI owns it: one fake group of
the largest mesh's size, 512 ranks with ``--both-meshes``, and the
``(16, 16)`` mesh on its first 256 (rank 0 is in both).  One group and one
process keep the cells in sequence, as ``repro`` runs them, at one group
start-up.  :func:`run_cell` runs inside a fake group only: in a real one
the step's collectives would run.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k [--multi-pod] [--both-meshes] [--out results.jsonl]
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback

from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.launch.mesh import ShapeMesh, make_production_mesh
from repro_torch.launch.specs import distribute_args, step_and_specs
from repro_torch.models.sharding import use_policy
from repro_torch.roofline.analysis import (
    analyze_step,
    fake_mesh,
    fake_process_group,
    in_fake_group,
)
from repro_torch.train.tree import flatten

__all__ = ["run_cell", "main"]


def run_cell(arch: str, shape: str, mesh, *, verbose: bool = True, cfg=None) -> dict:
    """Build and run one cell as rank 0 of ``mesh`` (a ``DeviceMesh`` of the
    fake default group, or a ``ShapeMesh`` laid on its first ranks);
    returns its record."""
    if not in_fake_group():
        raise RuntimeError("run_cell runs inside a fake process group "
                           "(roofline.analysis.fake_process_group), never a real one")
    if isinstance(mesh, ShapeMesh):
        mesh = fake_mesh(mesh.shape, mesh.axis_names)
    cfg = cfg or get_config(arch)
    t0 = time.time()
    fn, args, specs, policy = step_and_specs(arch, shape, mesh, cfg=cfg)
    args = distribute_args(args, specs, mesh)
    t_build = time.time() - t0
    t0 = time.time()
    with use_policy(policy):
        analysis = analyze_step(fn, args, cfg, SHAPES[shape], mesh)
    t_run = time.time() - t0
    params = flatten(args[0])
    record = {
        "arch": arch,
        "shape": shape,
        "mesh": "x".join(map(str, mesh.shape)),
        "status": "ok",
        "build_s": round(t_build, 2),
        "run_s": round(t_run, 2),
        "flops": analysis["hlo_flops_per_dev"],
        "bytes_accessed": analysis["hlo_bytes_per_dev"],
        "params": sum(t.numel() for t in params.values()),
        "param_bytes": sum(t.to_local().numel() * t.element_size() for t in params.values()),
        **analysis,
    }
    if verbose:
        print(f"[dryrun] {arch} × {shape} × {record['mesh']}: OK "
              f"(build {t_build:.1f}s, run {t_run:.1f}s)")
        print(f"  memory: { {k: v for k, v in record.items() if k.endswith('in_bytes')} }")
        print(f"  per device: flops={record['flops']:.3e} bytes={record['bytes_accessed']:.3e} "
              f"collectives={record['collective_bytes_per_dev']}; dominant "
              f"{record['dominant']}, useful {record['useful_flops_ratio']:.3f}")
    return record


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="architecture id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    shapes = []
    if args.both_meshes or not args.multi_pod:
        shapes.append(make_production_mesh(multi_pod=False))
    if args.both_meshes or args.multi_pod:
        shapes.append(make_production_mesh(multi_pod=True))

    records = []
    t_all = time.time()
    with fake_process_group(max(math.prod(m.shape) for m in shapes)):
        meshes = [fake_mesh(m.shape, m.axis_names) for m in shapes]
        for arch, shape, skip in cells(args.arch):
            if args.shape and shape != args.shape:
                continue
            if skip:
                rec = {"arch": arch, "shape": shape, "status": "skip", "reason": skip}
                print(f"[dryrun] {arch} × {shape}: SKIP ({skip})")
                records.append(rec)
                continue
            for mesh in meshes:
                try:
                    records.append(run_cell(arch, shape, mesh))
                except Exception as e:  # a failure here is a bug in the system
                    traceback.print_exc()
                    records.append({
                        "arch": arch, "shape": shape, "mesh": "x".join(map(str, mesh.shape)),
                        "status": "fail", "error": f"{type(e).__name__}: {e}"})
    if args.out:
        with open(args.out, "a") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
    n_fail = sum(r["status"] == "fail" for r in records)
    print(f"[dryrun] {len(records)} records, {n_fail} failures, {time.time() - t_all:.1f} s")
    if n_fail:
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
