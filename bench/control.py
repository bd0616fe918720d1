"""The control of the comparison that decides ``correct``: it has to fail.

The configurations state no precision, so the control breaks a guarantee
that they state, a proper coloring: the plain reference is put in the
program's place with its conflict rounds left out (every part's speculative
coloring, as a program that skipped the rounds would return), and its
answer goes through the same comparison as the program's.  Run at a cell's
own size, on the card, on several seeds:

    python3 bench/control.py --workload hex252_d1.cold --seeds 1,2,3

It prints each seed's compared numbers beside their limits and exits 0 only
if every seed came out not correct.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Answer:
    """A reference result in the shape of the port's ``ColoringResult``."""
    colors: np.ndarray
    rounds: int
    converged: bool
    total_conflicts: int
    comm_bytes_by_round: np.ndarray
    n_colors: int


def control_checks(cell: dict, seed: int, device: str, overrides=None, mix=None) -> dict:
    """The compared numbers of the control on one seed: ``{name: value}``
    (``overrides`` and ``mix`` as ``harness.run_cell`` takes them)."""
    from bench import harness
    from bench.kinds import coloring
    from bench.reference.coloring import Topology

    config = harness.merged(harness.load_json(
        harness.BENCH / "configs" / f"{cell['config']}.json"), overrides)
    if mix is None:
        mix = harness.load_json(harness.BENCH / "traffic" / f"{cell['traffic']}.json")
    ell, _ = coloring.make_inputs(config, seed, device)
    topo = Topology(ell, config["n_parts"], config["problem"],
                    second_layer=config["second_layer"],
                    recolor_degrees=config["recolor_degrees"], device=device)
    traffic = coloring.Traffic(mix, ell.shape[0], seed, device)
    mask, colors0 = traffic.inputs(0, topo.color() if not traffic.cold else None)
    spec = topo.color(colors0, mask, resolve=False)
    answer = Answer(spec.colors, spec.rounds, spec.converged, spec.total_conflicts,
                    spec.bytes_by_round, spec.n_colors)
    summary = coloring.summary(answer)
    prog = {"kept": [coloring.Kept(0, mask, colors0, answer)], "start": None,
            "failed": 0, "summaries": [summary]}
    checks, _ = coloring.judge(ell, config, prog, device)
    return {name: (value, limit) for name, value, limit in checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness

    cell = harness.workload(harness.load_benchmark(ROOT), args.workload)
    caught = True
    for seed in (int(s) for s in args.seeds.split(",")):
        checks = control_checks(cell, seed, args.device)
        correct = all(v <= lim for v, lim in checks.values())
        caught &= not correct
        print(f"control {args.workload} seed {seed} correct {correct} "
              + " ".join(f"{k}={v}(limit {lim})" for k, (v, lim) in checks.items()),
              flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
