"""Dry run of every (arch × shape × mesh) cell on the meta device: the
counterpart of ``repro/launch/dryrun.py``.

For each runnable cell, with no device memory and no process group:
  * the cell's step (``launch/specs.py``) runs once on meta tensors under
    ``torch.utils.flop_counter.FlopCounterMode``: the step's FLOPs, which
    the mesh does not change (``--both-meshes`` runs each cell's step
    once);
  * each device's argument bytes from the fitted specs on the mesh (the
    parameters, ``m`` and ``v``, the batch, or the token and the cache).
The meshes are ``repro``'s production meshes as names and sizes
(``launch/mesh.py::make_production_mesh``).  ``repro`` compiles each cell
with XLA and parses its HLO (``roofline/analysis.py``); the port has no
HLO, so its records hold no compiler memory analysis and no collective
bytes.

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

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import cells
from repro_torch.launch.mesh import axis_sizes, make_production_mesh
from repro_torch.launch.specs import step_and_specs
from repro_torch.train.tree import flatten

__all__ = ["device_bytes", "run_cell", "main"]


def device_bytes(tree, specs, mesh) -> int:
    """One device's bytes of ``tree`` laid out by ``specs`` on ``mesh``: each
    leaf's bytes over the product of the axis sizes that split it."""
    sizes = axis_sizes(mesh)
    flat, flat_specs = flatten(tree), flatten(specs)
    total = 0
    for key, leaf in flat.items():
        if leaf is None:
            continue
        parts = 1
        for entry in flat_specs[key] or ():
            for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
                parts *= sizes[a]
        total += leaf.numel() * leaf.element_size() // parts
    return total


def _as_tree(x) -> dict:
    return x if isinstance(x, dict) else {"": x}


def run_cell(arch: str, shape: str, mesh, *, verbose: bool = True, cfg=None,
             flops: float | None = None) -> dict:
    """Build and run one cell on the meta device; returns its record.
    ``flops``, where given, is the step's count from another mesh, and the
    step does not run again."""
    t0 = time.time()
    fn, args, specs = step_and_specs(arch, shape, mesh, cfg=cfg)
    t_build = time.time() - t0
    t0 = time.time()
    if flops is None:
        with FlopCounterMode(display=False) as counter:
            fn(*args)
        flops = float(counter.get_total_flops())
    t_run = time.time() - t0
    arg_bytes = [device_bytes(_as_tree(a), _as_tree(s), mesh) for a, s in zip(args, specs)]
    record = {
        "arch": arch,
        "shape": shape,
        "mesh": "x".join(map(str, mesh.shape)),
        "status": "ok",
        "build_s": round(t_build, 2),
        "run_s": round(t_run, 2),
        "params": sum(t.numel() for t in flatten(args[0]).values()),
        "flops": flops,
        "flops_per_device": flops / math.prod(mesh.shape),
        "argument_size_in_bytes": sum(arg_bytes),
        "param_bytes": arg_bytes[0],
    }
    if verbose:
        print(f"[dryrun] {arch} × {shape} × {record['mesh']}: OK "
              f"(build {t_build:.1f}s, run {t_run:.1f}s)")
        print(f"  per-device argument bytes {record['argument_size_in_bytes']:.4g} "
              f"(parameters {record['param_bytes']:.4g}); flops={record['flops']:.3e}")
    return record


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="architecture id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    meshes = []
    if args.both_meshes or not args.multi_pod:
        meshes.append(make_production_mesh(multi_pod=False))
    if args.both_meshes or args.multi_pod:
        meshes.append(make_production_mesh(multi_pod=True))

    records = []
    t_all = time.time()
    for arch, shape, skip in cells(args.arch):
        if args.shape and shape != args.shape:
            continue
        if skip:
            rec = {"arch": arch, "shape": shape, "status": "skip", "reason": skip}
            print(f"[dryrun] {arch} × {shape}: SKIP ({skip})")
            records.append(rec)
            continue
        flops = None
        for mesh in meshes:
            try:
                records.append(run_cell(arch, shape, mesh, flops=flops))
                flops = records[-1]["flops"]
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
