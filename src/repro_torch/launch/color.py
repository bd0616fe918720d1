"""Distributed-coloring CLI (the paper's workload as a CLI), PyTorch port.

  PYTHONPATH=src python -m repro_torch.launch.color --graph hex:24,24,24 \
      --parts 8 [--problem d1|d1_2gl|d2|pd2] \
      [--backend cuda|cuda_fused|reference] [--device cuda|cpu] \
      [--exchange all_gather|halo|delta|sparse_delta|hier_delta] \
      [--strategy block|edge_balanced|random] [--node-size L] \
      [--no-recolor-degrees] [--engine auto|simulate] [--baseline] \
      [--repeat 16] [--reduce-passes P [--reduce-order reverse]]
  PYTHONPATH=src python -m repro_torch.launch.color \
      --stream "hex:8,6,6|grid:16,16" --requests 8 [options above]
  PYTHONPATH=src torchrun --nproc-per-node=4 -m repro_torch.launch.color \
      --graph hex:24,8,8 --parts 4 --engine shard_map [--device cpu]

Graph specs: hex:NX,NY,NZ | grid:NX,NY | rmat:SCALE,EF | rgg:N,R |
myc:K | er:N,DEG | bip:ROWS,COLS,NNZ (with --problem pd2 for the Jacobian
workload)

Colors on the ``simulate`` engine (every part stacked on one device) or,
with --engine shard_map, on the multi-GPU engine.
--problem selects distance-1, distance-1 with two ghost layers,
distance-2 or partial distance-2 (all but d1 partition with a second
ghost layer).  --backend selects the plain PyTorch ``reference``, the
chained hand-written ``cuda`` kernels or ``cuda_fused`` (one kernel per
round); --device the device (the CPU runs the kernels' plain versions).
--exchange selects the ghost exchange; the reported comm/round is its
measured payload (``halo`` needs a slab partition and raises
``ValueError`` otherwise).  The sparse exchanges apply received pairs
with the ``pair_scatter`` kernel when --backend is a kernel backend.
--strategy selects the partitioner and --node-size L a two-level
partition of L parts per node (0 = flat; pairs with ``hier_delta``).

--engine selects the engine: ``simulate``, ``shard_map`` or ``auto`` (the
default, ``simulate`` in a single process).  ``shard_map`` runs one
process per part under ``torchrun --nproc-per-node=P``: each process joins
the group torchrun describes in its environment (``nccl`` after
``torch.cuda.set_device(LOCAL_RANK)`` for --device cuda, ``gloo`` for
--device cpu) and colors its own part; rank 0 prints the result lines,
every rank validates the coloring and exits 1 on an improper one.
Without torchrun's environment it exits with a message.  --stream and
--repeat serve through ``ColoringFrontend`` / ``ColoringService`` on the
engine; --baseline colors on every rank's own device alike, and its
--reduce-passes run on the engine.
--baseline colors with the Bozdağ/Zoltan-style batched-boundary baseline
(``repro_torch.core.baseline``; the reference backend and ``all_gather``).

--repeat N is the timestep mode (the paper's motivating workload): the
same topology is recolored N times through one plan of the plan cache
(``repro_torch.serve.ColoringService``), whose device state is uploaded
once; ``compile_ms=`` is the time of the programs' first runs, which pay
the one-time costs (eager PyTorch compiles nothing: the kernel libraries'
first load and the allocator's first blocks), and ``warm_ms=`` the mean
execution of the timesteps.

--stream "spec|spec|..." is the mixed-topology replay mode: --requests N
requests are enqueued round-robin over the listed graph specs and served
by the continuous-batching ``ColoringFrontend`` (plans routed per
topology through the plan cache, finished slots refilled from the
queue).  The stream is replayed twice — the first pass pays every
topology's plan build and first runs, the second runs warm — and
requests per second are reported for both, with ``refills=``.  It exits
1 on an improper coloring or a warm replay that differs from the first.

--reduce-passes P runs up to P iterative color-reduction passes
(``repro_torch.core.reduce``) over the finished coloring, rebuilding its
color classes in --reduce-order; the colors-vs-passes trajectory and the
measured per-pass comm payload are printed, and the final (reduced)
coloring is validated.  The CLI exits 1 on a coloring that is not proper
for its problem.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.core.backend import list_backends
from repro_torch.core.baseline import color_baseline
from repro_torch.core.distributed import PROBLEMS
from repro_torch.core.exchange import list_exchanges
from repro_torch.core.plan import get_plan
from repro_torch.core.quality import trajectory
from repro_torch.core.reduce import list_orders, reduce_colors
from repro_torch.core.validate import is_proper_d1, is_proper_d2, is_proper_pd2
from repro_torch.graph import generators as gen
from repro_torch.graph.partition import partition_graph, two_level_partition
from repro_torch.launch.mesh import factor_parts
from repro_torch.serve.coloring import (
    ColoringFrontend,
    ColoringRequest,
    ColoringService,
)


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


def make_partition(g, args):
    """Flat or two-level partition per ``--node-size`` (0 = flat)."""
    needs_l2 = args.problem != "d1"
    if args.node_size:
        n_nodes, node_size = factor_parts(args.parts, args.node_size)
        return two_level_partition(g, n_nodes, node_size,
                                   strategy=args.strategy,
                                   second_layer=needs_l2)
    return partition_graph(g, args.parts, strategy=args.strategy,
                           second_layer=needs_l2)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_stream(args, say=print) -> None:
    """Mixed-topology replay through the continuous-batching frontend,
    printed by ``say``."""
    specs = [s for s in args.stream.split("|") if s]
    graphs = [make_graph(s) for s in specs]
    pgs = []
    for g, spec in zip(graphs, specs):
        pg = make_partition(g, args)
        pgs.append(pg)
        say(f"[color] topology {spec}: n={g.n} m={g.num_edges} "
            f"sig={pg.signature[:12]}")
    fe = ColoringFrontend(
        problem=args.problem, recolor_degrees=not args.no_recolor_degrees,
        backend=args.backend, exchange=args.exchange, engine=args.engine,
        reduce_passes=args.reduce_passes, reduce_order=args.reduce_order,
        device=args.device)
    pairs = [(pgs[i % len(pgs)], ColoringRequest())
             for i in range(args.requests)]

    t0 = time.time()
    cold_results = fe.run_stream(pairs)         # results are on the host
    cold_s = time.time() - t0
    t0 = time.time()
    results = fe.run_stream(pairs)              # warm replay
    warm_s = time.time() - t0
    first_for_pg = {}
    for (pg, _), cold, warm in zip(pairs, cold_results, results):
        g = graphs[pgs.index(pg)]
        first_for_pg.setdefault(id(pg), warm)
        if not VALIDATORS[args.problem](g, warm.colors):
            raise SystemExit(f"improper coloring for {g.name}")
        if (cold.colors != warm.colors).any():
            raise SystemExit(f"warm replay diverged for {g.name}")
    s = fe.stats
    say(f"[color] stream topologies={len(pgs)} requests={args.requests} "
        f"req/s cold={args.requests / cold_s:.1f} "
        f"warm={args.requests / warm_s:.1f} "
        f"(compile {s.cold_ms:.0f}ms over {s.cold_runs} programs; "
        f"warm {s.warm_ms_mean:.2f}ms/request; refills={s.refills})")
    # Only topologies the stream actually reached (requests may be fewer).
    for spec, pg in zip(specs[:args.requests], pgs):
        res = first_for_pg[id(pg)]
        say(f"[color]   {spec}: colors={res.n_colors} rounds={res.rounds} "
            f"comm_total={res.comm_bytes_total}B")


def start_group(args) -> int:
    """``--engine shard_map``: join the process group torchrun describes in
    the environment and return this process's rank."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise SystemExit(
            "--engine shard_map runs one process per part: start it with "
            f"torchrun --nproc-per-node={args.parts} -m repro_torch.launch.color ...")
    if args.device == "cpu":
        dist.init_process_group("gloo")
    else:
        card = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(card)
        dist.init_process_group("nccl", device_id=card)
    return dist.get_rank()


def parser() -> argparse.ArgumentParser:
    """The CLI's arguments (``main`` parses with it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph")
    ap.add_argument("--stream", metavar="SPEC|SPEC|...",
                    help="mixed-topology replay: serve --requests N "
                         "round-robin over these graph specs through the "
                         "continuous-batching frontend")
    ap.add_argument("--requests", type=int, default=16,
                    help="stream mode: total requests to replay")
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--problem", default="d1", choices=PROBLEMS)
    ap.add_argument("--backend", default="cuda", choices=list_backends())
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--exchange", default="all_gather", choices=list_exchanges())
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "shard_map", "simulate"])
    ap.add_argument("--strategy", default="block",
                    choices=["block", "edge_balanced", "random"])
    ap.add_argument("--node-size", type=int, default=0, metavar="L",
                    help="two-level partition: L parts per node "
                         "(0 = flat; pairs with --exchange hier_delta)")
    ap.add_argument("--no-recolor-degrees", action="store_true")
    ap.add_argument("--baseline", action="store_true",
                    help="Bozdağ/Zoltan-style batched boundary coloring")
    ap.add_argument("--repeat", type=int, default=1, metavar="N",
                    help="timestep mode: recolor the topology N times "
                         "through the plan cache, report first-run vs warm ms")
    ap.add_argument("--reduce-passes", type=int, default=0, metavar="P",
                    help="post-color quality: up to P iterative color-"
                         "reduction passes (repro_torch.core.reduce)")
    ap.add_argument("--reduce-order", default="reverse", choices=list_orders(),
                    help="class-rebuild order used by --reduce-passes")
    return ap


def main(argv=None) -> None:
    ap = parser()
    args = ap.parse_args(argv)

    rank = start_group(args) if args.engine == "shard_map" else 0
    try:
        run_one(ap, args, print if rank == 0 else (lambda *a, **k: None))
    finally:
        if args.engine == "shard_map" and dist.is_initialized():
            dist.destroy_process_group()


def run_one(ap, args, say) -> None:
    """One coloring (or a stream), printed by ``say``."""
    if args.stream:
        run_stream(args, say)
        return
    if not args.graph:
        ap.error("one of --graph or --stream is required")
    g = make_graph(args.graph)
    say(f"[color] graph {g.name}: n={g.n} m={g.num_edges} "
        f"maxdeg={g.max_degree}")
    pg = make_partition(g, args)
    recolor_degrees = not args.no_recolor_degrees
    t0 = time.time()
    if args.baseline:
        if args.backend != "reference" or args.exchange != "all_gather":
            say("[color] note: --baseline uses the reference backend and "
                  "all_gather exchange; --backend/--exchange are ignored")
        res = color_baseline(pg, problem=args.problem,
                             recolor_degrees=recolor_degrees, device=args.device)
        target = pg
    elif args.repeat > 1:
        svc = ColoringService(
            pg, problem=args.problem, recolor_degrees=recolor_degrees,
            backend=args.backend, exchange=args.exchange,
            engine=args.engine, reduce_passes=args.reduce_passes,
            reduce_order=args.reduce_order, device=args.device)
        for _ in range(args.repeat):
            res = svc.submit()
        say(f"[color] repeat={args.repeat} engine={svc.engine} "
              f"compile_ms={svc.stats.cold_ms:.1f} "
              f"({svc.stats.cold_runs} programs, paid once) "
              f"warm_ms={svc.stats.warm_ms_mean:.2f} "
              f"(mean execution of {svc.stats.warm_requests} timesteps)")
    else:
        target = get_plan(
            pg, problem=args.problem, recolor_degrees=recolor_degrees,
            backend=args.backend, exchange=args.exchange,
            engine=args.engine, device=args.device)
        res = target.run()
    if args.reduce_passes > 0 and (args.baseline or args.repeat <= 1):
        red = reduce_colors(target, res, passes=args.reduce_passes,
                            order=args.reduce_order, problem=args.problem,
                            recolor_degrees=recolor_degrees,
                            backend="reference", exchange="all_gather",
                            engine=args.engine, device=args.device)
        say(f"[color] reduce order={args.reduce_order} "
              f"passes={red.passes_run}/{args.reduce_passes} "
              f"colors {red.initial_n_colors} -> {red.n_colors} "
              f"({trajectory(red.colors_by_pass, red.comm_bytes_by_pass)})")
        res = red.merged_result(res)
    _sync(torch.device(args.device))
    dt = time.time() - t0
    ok = VALIDATORS[args.problem](g, res.colors)
    say(f"[color] {res.problem} parts={res.n_parts} "
          f"backend={res.backend} exchange={res.exchange} "
          f"colors={res.n_colors} rounds={res.rounds} "
          f"conflicts={res.total_conflicts} proper={ok} "
          f"converged={res.converged} "
          f"comm/round={res.comm_bytes_per_round}B "
          f"comm_total={res.comm_bytes_total}B time={dt:.2f}s "
          f"(device={args.device})")
    if res.comm_bytes_by_round is not None:
        say(f"[color] comm_bytes_by_round="
              f"{[int(b) for b in res.comm_bytes_by_round]}")
    if res.comm_bytes_by_level is not None and res.comm_bytes_intra:
        say(f"[color] comm_bytes intra-node={res.comm_bytes_intra}B "
              f"inter-node={res.comm_bytes_inter}B")
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
