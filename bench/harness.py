"""The benchmark's machinery that no cell owns.

Everything that belongs to one configuration, traffic mix, kind of system
path or per-layer metric sits in a file of its own, found here by the
name that ``BENCHMARK.json`` gives it:

* ``bench/configs/<config>.json`` -- a configuration, with its ``kind``;
* ``bench/traffic/<traffic>.json`` -- a traffic mix, parameters only;
* ``bench/kinds/<kind>.py`` -- the path a kind of configuration drives:
  ``run(config, traffic, seed, seconds, trace, device, t_start)``;
* ``bench/metrics/<metric>.py`` -- a per-layer metric's reader,
  ``read(record) -> float | None``, ``None`` where it finds nothing.

Also here: the result line and its checks, the
scan of ``sys.modules`` for JAX, and the reduction of a ``torch.profiler``
trace to the device's busy time, its top operations and its idle gaps.
"""
from __future__ import annotations

import bisect
import contextlib
import copy
import importlib
import importlib.util
import json
import sys
import time
import warnings
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TOP = 10                # entries of each breakdown list
OWN = "harness"         # span of the harness's own work: its device time is not the program's


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                   f"cells: {[c['name'] for c in bench['workloads']]}")


def merged(base: dict, over: dict | None) -> dict:
    """``base`` with the keys of ``over`` laid over it, nested dicts merged."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def applies(metric: dict, cell: dict) -> bool:
    return "workloads" not in metric or cell["name"] in metric["workloads"]


def metric_reader(name: str, bench_dir: Path = BENCH):
    """The module ``bench/metrics/<name>.py`` (a name may hold dots)."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def run_cell(cell: dict, *, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, bench: dict | None = None, bench_dir: Path = BENCH,
             overrides: dict | None = None, mix: dict | None = None) -> dict:
    """One run of ``cell``: the result line as a dict, ``checks`` last.

    ``overrides`` lays keys over the configuration (the tests shrink the
    graph with it); ``mix``, where given, is the traffic mix itself in
    place of its file; ``bench_dir`` is the folder the pieces are read from.
    """
    bench = bench if bench is not None else load_benchmark(bench_dir.parent)
    config = merged(load_json(bench_dir / "configs" / f"{cell['config']}.json"), overrides)
    traffic = mix if mix is not None else load_json(
        bench_dir / "traffic" / f"{cell['traffic']}.json")
    kind = importlib.import_module(f"{bench_dir.name}.kinds.{config['kind']}")
    out = kind.run(config=config, traffic=traffic, seed=seed, seconds=seconds,
                   trace=trace, device=device, t_start=t_start)
    metrics = {}
    if trace:
        for m in bench["per_layer"]:
            if applies(m, cell):
                value = metric_reader(m["name"], bench_dir).read(out["record"])
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, cell):
                metrics[m["name"]] = {"value": out["end_to_end"][m["name"]],
                                      "unit": m["unit"]}
    checks = {name: {"value": value, "limit": limit}
              for name, value, limit in out["checks"]}
    line = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": out["device"]}
    if trace:
        line["breakdown"] = out["breakdown"]
    line["checks"] = checks
    return line


def emit(line: dict) -> None:
    """Each number compared beside its limit as the last lines on standard
    error, then the result as the last line of standard output."""
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


# ---------------------------------------------------------------------------
# Spans and the device trace.
# ---------------------------------------------------------------------------

class Tracer:
    """Spans on the host clock around the calls into each layer and, when
    ``on``, the same spans as ``torch.profiler`` annotations, the profiler
    over the window, and a count of the host's syncs with the device."""

    def __init__(self, on: bool, device):
        self.on = on
        self.cuda = on and str(device).startswith("cuda")
        self.spans: list[tuple[str, float, float]] = []
        self.syncs = 0
        self.prof = None

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            try:
                yield
            finally:
                self.spans.append((name, t0, time.perf_counter()))

    def wrap(self, name: str, fn):
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped

    @contextlib.contextmanager
    def quiet(self):
        """The harness's own syncs (inputs, the group's clock) uncounted."""
        if not self.cuda:
            yield
            return
        import torch

        torch.cuda.set_sync_debug_mode("default")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    @contextlib.contextmanager
    def window(self):
        """Profile the window and count its syncs (sync debug mode)."""
        if not self.on:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with profile(activities=acts) as prof:
                if self.cuda:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    with self.span("window"):
                        yield
                finally:
                    if self.cuda:
                        torch.cuda.set_sync_debug_mode("default")
                        torch.cuda.synchronize()
        self.syncs = sum(1 for w in caught if "synchroniz" in str(w.message))
        self.prof = prof

    def device_time(self) -> dict:
        """``busy_s`` (the union of the device's operations over the traced
        window), ``window_s``, the top device operations by time, and the
        idle gaps summed by the innermost span the host was in."""
        from torch.autograd import DeviceType

        labels = {name for name, _, _ in self.spans}
        events = self.prof.events()
        cpu = [(e.name, e.time_range.start, e.time_range.end) for e in events
               if e.device_type == DeviceType.CPU and e.name in labels]
        win = [(s, t) for name, s, t in cpu if name == "window"]
        w0, w1 = win[0] if win else (0.0, 0.0)
        own = sorted((s, t) for name, s, t in cpu if name == OWN)
        own_starts = [s for s, _ in own]

        def harness_op(s, t):
            """A device operation that ran wholly inside a span of the
            harness's own work (the traffic's inputs)."""
            i = bisect.bisect_right(own_starts, s) - 1
            return i >= 0 and own[i][1] >= t

        dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                     if e.device_type != DeviceType.CPU and e.name not in labels
                     and e.time_range.end > w0 and e.time_range.start < w1
                     and not harness_op(e.time_range.start, e.time_range.end))
        by_name: dict[str, float] = {}
        busy, gaps, edge = 0.0, [], w0
        for s, t, name in dev:
            by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e6
            s, t = max(s, w0), min(t, w1)
            if s > edge:
                gaps.append((edge, s))
            busy += max(0.0, t - max(s, edge))
            edge = max(edge, t)
        if w1 > edge:
            gaps.append((edge, w1))
        # Spans nest (a request holds its layers) and siblings do not
        # overlap, so the innermost span over a point is the latest-starting
        # one that has not ended before it.
        spans = sorted((s, t, name) for name, s, t in cpu if name not in ("window", OWN))
        starts = [s for s, _, _ in spans]
        idle: dict[str, float] = {}
        for s, t in gaps:
            mid, name = (s + t) / 2, OWN
            for a, b, n in reversed(spans[max(0, bisect.bisect_right(starts, mid) - 8):
                                          bisect.bisect_right(starts, mid)]):
                if b >= mid:
                    name = n
                    break
            idle[name] = idle.get(name, 0.0) + (t - s) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return {"busy_s": busy / 1e6, "window_s": (w1 - w0) / 1e6,
                "device_ops": [[n[:200], v] for n, v in top],
                "idle_gaps": [[n, v] for n, v in
                              sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]]}
