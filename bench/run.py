"""Run one cell of the benchmark once, on the machine it is started on.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell, its configuration, traffic
mix and metrics are found by name from ``BENCHMARK.json``
(``bench/harness.py``).  The last line of standard output is the result as
one JSON object; the last lines of standard error give each number
compared beside its limit.  Without a CUDA card, with fewer cards than the
cell asks for, without the port beside ``bench/``, or when JAX or the JAX
package was loaded, it prints no result and exits with a code other than 0.
"""
import time

T_START = time.perf_counter()           # set-up is timed from here

import argparse                         # noqa: E402
import os                               # noqa: E402
import sys                              # noqa: E402
from pathlib import Path                # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # Every kernel cache at a fixed path inside the checkout, so that only a
    # checkout's first run builds.
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the port (src/repro_torch) is not beside bench/", file=sys.stderr)
        return 2

    import torch

    from bench import harness

    bench = harness.load_benchmark(ROOT)
    cell = harness.workload(bench, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    line = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                            trace=bool(args.trace), device="cuda", t_start=T_START,
                            bench=bench)
    found = harness.forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    harness.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
