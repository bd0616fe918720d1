"""Distributed-coloring CLI (the paper's workload as a CLI), PyTorch port.

  PYTHONPATH=src python -m repro_torch.launch.color --graph hex:24,24,24 \
      --parts 8 [--problem d1|d1_2gl|d2|pd2] \
      [--backend cuda|cuda_fused|reference] [--device cuda|cpu] \
      [--no-recolor-degrees] [--repeat 16]

Graph specs: hex:NX,NY,NZ | grid:NX,NY | rmat:SCALE,EF | rgg:N,R |
myc:K | er:N,DEG | bip:ROWS,COLS,NNZ (with --problem pd2 for the Jacobian
workload)

Colors on the ``simulate`` engine (every part stacked on one device) with
the ``all_gather`` exchange.  --problem selects distance-1, distance-1
with two ghost layers, distance-2 or partial distance-2 (all but d1
partition with a second ghost layer).  --backend selects the plain
PyTorch ``reference``, the chained hand-written ``cuda`` kernels or
``cuda_fused`` (one kernel per round); --device the device (the CPU runs
the kernels' plain versions).

--repeat N is the timestep mode (the paper's motivating workload): the
same topology is recolored N times through one plan, whose device state
is uploaded once; the first and the mean later request times are
reported.  The CLI exits 1 on a coloring that is not proper for its
problem.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.backend import list_backends
from repro_torch.core.distributed import PROBLEMS
from repro_torch.core.plan import ColoringPlan
from repro_torch.core.validate import is_proper_d1, is_proper_d2, is_proper_pd2
from repro_torch.graph import generators as gen
from repro_torch.graph.partition import partition_graph


def make_graph(spec: str):
    kind, _, rest = spec.partition(":")
    args = [float(x) if "." in x else int(x) for x in rest.split(",")] if rest else []
    return {
        "hex": lambda: gen.hex_mesh(*args),
        "grid": lambda: gen.grid_2d(*args),
        "rmat": lambda: gen.rmat(*args),
        "rgg": lambda: gen.random_geometric(args[0], args[1]),
        "myc": lambda: gen.mycielskian(*args),
        "er": lambda: gen.erdos_renyi(args[0], args[1]),
        "bip": lambda: gen.bipartite_random(*args),
    }[kind]()


VALIDATORS = {
    "d1": is_proper_d1, "d1_2gl": is_proper_d1,
    "d2": is_proper_d2, "pd2": is_proper_pd2,
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", required=True)
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--problem", default="d1", choices=PROBLEMS)
    ap.add_argument("--backend", default="cuda", choices=list_backends())
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--no-recolor-degrees", action="store_true")
    ap.add_argument("--repeat", type=int, default=1, metavar="N",
                    help="timestep mode: recolor the topology N times "
                         "through one plan, report first vs later ms")
    args = ap.parse_args(argv)

    g = make_graph(args.graph)
    print(f"[color] graph {g.name}: n={g.n} m={g.num_edges} "
          f"maxdeg={g.max_degree}")
    pg = partition_graph(g, args.parts, second_layer=args.problem != "d1")
    t0 = time.time()
    plan = ColoringPlan(pg, problem=args.problem,
                        recolor_degrees=not args.no_recolor_degrees,
                        backend=args.backend, device=args.device)
    times = []
    for _ in range(max(args.repeat, 1)):
        t1 = time.perf_counter()
        res = plan.run()
        _sync(plan.device)
        times.append((time.perf_counter() - t1) * 1e3)
    dt = time.time() - t0
    if args.repeat > 1:
        later = times[1:]
        print(f"[color] repeat={args.repeat} first_ms={times[0]:.1f} "
              f"later_ms={sum(later) / len(later):.2f} "
              f"(mean of {len(later)} requests through one plan)")
    ok = VALIDATORS[args.problem](g, res.colors)
    print(f"[color] {res.problem} parts={res.n_parts} "
          f"backend={res.backend} exchange={res.exchange} "
          f"colors={res.n_colors} rounds={res.rounds} "
          f"conflicts={res.total_conflicts} proper={ok} "
          f"converged={res.converged} "
          f"comm/round={res.comm_bytes_per_round}B "
          f"comm_total={res.comm_bytes_total}B time={dt:.2f}s "
          f"(device={plan.device})")
    print(f"[color] comm_bytes_by_round="
          f"{[int(b) for b in res.comm_bytes_by_round]}")
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
