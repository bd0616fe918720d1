"""The port's continuous-batching ``ColoringFrontend`` against ``repro``'s,
and the CLI's ``--stream`` and ``--repeat`` modes against ``repro``'s CLI.

The counterparts of ``tests/test_serve_stream.py``.  Each scenario runs
once on each package, over the same ``PartitionedGraph`` topologies and
the same requests, and records what a caller can observe: results (every
field), ``ServiceStats`` counters, buckets, programs, ticket states, the
order in which requests start, admission errors.  The two records must be
equal, and every port result must equal the port's own solo
``plan.run`` (plus ``reduce_colors`` where the frontend reduces).
``repro`` runs its ``reference`` backend on ``simulate``.  Its assertions
on XLA compile time (``warm_ms_mean < cold_ms``) are not ported.
"""
import copy
import os
import pathlib
import subprocess
import sys
import types
import warnings

import numpy as np
import pytest
import torch

import repro.core.plan as j_plan
import repro.core.reduce as j_reduce
import repro.launch.color as j_cli
import repro.serve as j_serve
import repro.serve.coloring as j_coloring
from repro.graph import generators as j_gen
from repro.graph.partition import partition_graph as j_partition
import repro_torch.core.plan as t_plan
import repro_torch.core.reduce as t_reduce
import repro_torch.launch.color as t_cli
import repro_torch.serve as t_serve
import repro_torch.serve.coloring as t_coloring
from repro_torch.core.validate import is_proper_d1
from repro_torch.graph import generators as t_gen
from repro_torch.graph.partition import partition_graph as t_partition

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRAPHS = {"hex": ("hex_mesh", (6, 4, 4)), "grid": ("grid_2d", (12, 12)),
          "myc": ("mycielskian", (6,))}
STAT_FIELDS = ("requests", "batches", "refills", "warm_requests", "rejected",
               "shed", "by_tenant", "cold_runs")
RESULT_FIELDS = ("colors", "rounds", "converged", "total_conflicts", "n_colors",
                 "comm_bytes_total", "comm_bytes_per_round", "comm_bytes_by_round",
                 "comm_bytes_by_level")


def _package(name):
    """One package's serving API over its own copies of :data:`GRAPHS`."""
    if name == "repro":
        gen, part, kw = j_gen, j_partition, {"engine": "simulate"}
        mods = dict(serve=j_serve, coloring=j_coloring, plan=j_plan, reduce=j_reduce)
    else:
        gen, part, kw = t_gen, t_partition, {"device": "cpu"}
        mods = dict(serve=t_serve, coloring=t_coloring, plan=t_plan, reduce=t_reduce)
    graphs = {k: getattr(gen, fn)(*args) for k, (fn, args) in GRAPHS.items()}
    pgs = {k: part(g, 3, strategy="block", second_layer=True)
           for k, g in graphs.items()}
    return types.SimpleNamespace(name=name, graphs=graphs, pgs=pgs, kw=kw, **mods)


PKGS = {name: _package(name) for name in ("repro", "port")}
PORT = PKGS["port"]


def frontend(pkg, **kw):
    return pkg.serve.ColoringFrontend(cache=pkg.plan.PlanCache(), **pkg.kw, **kw)


def result_record(res) -> tuple:
    return tuple(None if getattr(res, f) is None else np.asarray(getattr(res, f)).tolist()
                 for f in RESULT_FIELDS)


def stats_record(fe) -> dict:
    return copy.deepcopy({f: getattr(fe.stats, f) for f in STAT_FIELDS})


def solo(pkg, fe, pg, req, reduce_passes=0):
    """The solo run of ``req`` on ``pg`` with ``fe``'s configuration, in a
    cache of its own."""
    cache = pkg.plan.PlanCache()
    plan = pkg.plan.get_plan(pg, cache=cache, **fe._cfg)
    base = plan.run(**req)
    if not reduce_passes:
        return base
    return pkg.reduce.reduce_colors(plan, base, passes=reduce_passes, cache=cache,
                                    color_mask=req.get("color_mask")).merged_result(base)


def both(scenario, **kw) -> dict:
    """Run ``scenario(pkg, **kw)`` on both packages; their records must be
    equal.  Returns the port's."""
    records = {name: scenario(pkg, **kw) for name, pkg in PKGS.items()}
    assert records["port"] == records["repro"]
    return records["port"]


def _mixed_stream(pkg, reps: int = 2, topologies=tuple(GRAPHS)):
    """Interleaved mixed-topology, mixed-request stream."""
    pairs = []
    for _ in range(reps):
        for pg in (pkg.pgs[k] for k in topologies):
            pairs.append((pg, {}))
            pairs.append((pg, {"color_mask": np.arange(pg.n_global) % 2 == 0}))
    return pairs


# ---------------------------------------------------------------------------
# Mixed-topology streams, equal to repro and to solo runs.
# ---------------------------------------------------------------------------

def _stream_scenario(pkg, reduce_passes):
    fe = frontend(pkg, reduce_passes=reduce_passes)
    pairs = (_mixed_stream(pkg) if reduce_passes == 0
             else _mixed_stream(pkg, reps=1, topologies=("hex", "myc")))
    results = fe.run_stream(pairs)
    record = {"results": [result_record(r) for r in results],
              "stats": stats_record(fe), "groups": len(fe._groups),
              "buckets": sorted(g.compiled_buckets for g in fe._groups.values()),
              "programs": fe.n_programs}
    if pkg is PORT:
        for (pg, req), res in zip(pairs, results):
            assert result_record(res) == result_record(
                solo(pkg, fe, pg, req, reduce_passes))
    plans = [g.plan for g in fe._groups.values()]
    traces = [p.stats.traces for p in plans]
    again = fe.run_stream(pairs)                      # fully warm replay
    assert [result_record(r) for r in again] == record["results"]
    assert [p.stats.traces for p in plans] == traces  # nothing built again
    record["warm_stats"] = stats_record(fe)
    return record


@pytest.mark.parametrize("reduce_passes", [0, 1])
def test_frontend_mixed_topology_stream(reduce_passes):
    """Three topologies through one frontend: results equal to ``repro``'s
    and to solo runs (plus solo ``reduce_colors``), one slot group and one
    bucket per topology, and a warm replay that builds nothing."""
    rec = both(_stream_scenario, reduce_passes=reduce_passes)
    assert rec["groups"] == (len(GRAPHS) if reduce_passes == 0 else 2)
    if reduce_passes == 0:
        assert rec["buckets"] == [[4]] * len(GRAPHS)     # 4 requests each
        assert rec["stats"]["cold_runs"] == 2 * len(GRAPHS)
        assert rec["warm_stats"]["cold_runs"] == rec["stats"]["cold_runs"]


def test_frontend_stream_warm_path_no_rebuild(monkeypatch):
    """After each topology's first batch the stream rebuilds no host state."""
    fe = frontend(PORT)
    pairs = _mixed_stream(PORT)
    fe.run_stream(pairs)                              # warm-up
    cold_runs = fe.stats.cold_runs

    def _forbidden(*a, **kw):
        raise AssertionError("warm stream rebuilt host state")

    monkeypatch.setattr(t_plan, "build_device_state", _forbidden)
    again = fe.run_stream(pairs)
    assert fe.stats.cold_runs == cold_runs
    assert all(is_proper_d1(PORT.graphs["hex"], r.colors)
               for (pg, req), r in zip(pairs, again)
               if pg is PORT.pgs["hex"] and not req)


def _routing_scenario(pkg):
    fe = frontend(pkg)
    sig = fe.register(pkg.pgs["grid"])
    assert sig == pkg.pgs["grid"].signature
    t = fe.enqueue(sig, {})
    out = fe.drain()
    record = {"result": result_record(out[t]), "sig": sig}
    for bad, exc in (("not-a-signature", KeyError), (sig, TypeError)):
        with pytest.raises(exc) as e:
            fe.enqueue(bad, {"mask": None} if exc is TypeError else {})
        record[exc.__name__] = str(e.value)
    return record


def test_frontend_signature_routing():
    rec = both(_routing_scenario)
    assert "unknown topology signature" in rec["KeyError"]
    assert "unknown request keys" in rec["TypeError"]


# ---------------------------------------------------------------------------
# Continuous batching: finished slots refill from the pending queue.
# ---------------------------------------------------------------------------

def _refill_scenario(pkg):
    pg = pkg.pgs["hex"]
    svc = pkg.serve.ColoringService(pg, cache=pkg.plan.PlanCache(), max_batch=4,
                                    **pkg.kw)
    n = pg.n_global
    masks = [None, np.arange(n) < n // 2, np.arange(n) % 2 == 0,
             np.arange(n) % 3 != 0, np.arange(n) >= n // 3]
    reqs = [{"color_mask": m} for m in masks * 2]     # 10 requests, 4 slots
    outs = svc.run_batch(reqs)
    if pkg is PORT:
        for req, out in zip(reqs, outs):
            assert result_record(out) == result_record(svc.plan.run(**req))
    return {"results": [result_record(r) for r in outs], "buckets": svc.buckets,
            "stats": stats_record(svc._frontend)}


def test_slots_refill_from_pending_queue():
    rec = both(_refill_scenario)
    assert rec["buckets"] == [4] and rec["stats"]["refills"] > 0
    assert rec["stats"]["batches"] == 1 and rec["stats"]["warm_requests"] == 10


# ---------------------------------------------------------------------------
# Programs are keyed per plan and die with it; eviction mid-stream.
# ---------------------------------------------------------------------------

def _eviction_scenario(pkg):
    hexg, grid = pkg.pgs["hex"], pkg.pgs["grid"]
    fe = pkg.serve.ColoringFrontend(cache=pkg.plan.PlanCache(maxsize=1), **pkg.kw)
    record = {}
    # A queued ticket whose plan is evicted before it runs still completes.
    t = fe.enqueue(hexg, {})
    queued, key_hex = t.state, next(iter(fe._groups))
    fe.run_stream([(grid, {})] * 2)
    record["hex evicted"] = key_hex not in fe._groups
    res = t.result()
    record["queued ticket"] = (queued, t.state, len(fe._retired), result_record(res))
    if pkg is PORT:
        assert result_record(res) == result_record(solo(pkg, fe, hexg, {}))
    programs_one = fe.n_programs
    fe.run_stream([(hexg, {})] * 2)
    record["programs"] = (programs_one, fe.n_programs, len(fe._groups))
    # A stream that thrashes the cache: in-flight requests pin their group.
    pairs = [(hexg, {}), (grid, {}),
             (hexg, {"color_mask": np.arange(hexg.n_global) % 2 == 0})]
    results = fe.run_stream(pairs)
    if pkg is PORT:
        for (pg, req), res in zip(pairs, results):
            assert result_record(res) == result_record(solo(pkg, fe, pg, req))
    record["thrash"] = ([result_record(r) for r in results], len(fe._retired))
    record["stats"] = stats_record(fe)
    fe.close()
    record["closed"] = (fe.n_programs, len(fe._groups))
    return record


def test_eviction_mid_stream():
    rec = both(_eviction_scenario)
    assert rec["hex evicted"]
    assert rec["queued ticket"][:3] == ("queued", "done", 0)
    assert rec["programs"] == (2, 2, 1)               # the survivor's only
    assert rec["thrash"][1] == 0                      # drained, then dropped
    assert rec["closed"] == (0, 0)


# ---------------------------------------------------------------------------
# Tickets, scheduling order, backpressure, tenant quotas.
# ---------------------------------------------------------------------------

def _ticket_scenario(pkg):
    fe = frontend(pkg)
    t = fe.submit(pkg.pgs["hex"], pkg.serve.ColoringRequest())
    record = {"submitted": (type(t).__name__, t.state, t.done())}
    res = t.result()
    record["resolved"] = (t.done(), t.state, t.result() is res, result_record(res))
    # A steady submit-only caller: a wave starts once max_batch is queued,
    # in-flight waves advance between submits, no drain() needed.
    fe = frontend(pkg, max_batch=2)
    tickets = [fe.submit(pkg.pgs["hex"], pkg.serve.ColoringRequest()) for _ in range(8)]
    record["pumped"] = (fe.stats.batches, sum(t.done() for t in tickets),
                        [t.state for t in tickets])
    results = fe.drain(tickets)
    record["drained"] = ([result_record(results[t]) for t in tickets],
                         stats_record(fe))
    if pkg is PORT:
        want = result_record(solo(pkg, fe, pkg.pgs["hex"], {}))
        assert all(result_record(results[t]) == want for t in tickets)
    return record


def test_submit_tickets_and_opportunistic_pumping():
    rec = both(_ticket_scenario)
    assert rec["submitted"] == ("Ticket", "queued", False)
    assert rec["resolved"][:3] == (True, "done", True)
    batches, done_before_drain, _ = rec["pumped"]
    assert batches >= 1 and done_before_drain > 0
    assert rec["drained"][1]["warm_requests"] == 8


def _order_scenario(pkg):
    fe = frontend(pkg, max_batch=1)
    order = []
    orig = fe._note_running
    fe._note_running = lambda t: (order.append(t.id), orig(t))[1]
    req = pkg.serve.ColoringRequest
    tickets = [fe.enqueue(pkg.pgs["hex"], r) for r in (
        req(), req(deadline_ms=60_000), req(deadline_ms=5), req(priority=5),
        req(priority=5, deadline_ms=1))]
    fe.drain()
    return {"order": order, "ids": [t.id for t in tickets],
            "states": [t.state for t in tickets]}


def test_priority_deadline_scheduling_order(monkeypatch):
    """Highest priority first, ties by the earliest deadline, no deadline
    last; the admission clock is frozen so both packages see one."""
    monkeypatch.setattr(t_coloring.time, "monotonic", lambda: 1_000.0)
    rec = both(_order_scenario)
    low, far, soon, high, high_soon = rec["ids"]
    assert rec["order"] == [high_soon, high, soon, far, low]
    assert rec["states"] == ["done"] * 5


def _admission_scenario(pkg, case):
    """Admission outcomes before any request runs; the port's queue then
    drains and each result equals its solo run."""
    req = pkg.serve.ColoringRequest
    hexg = pkg.pgs["hex"]
    record = {}
    if case == "reject":
        fe = frontend(pkg, max_pending=2, admission="reject")
        keep = [fe.enqueue(hexg, req()), fe.enqueue(hexg, req())]
        record["pending"] = fe.pending
        with pytest.raises(pkg.serve.AdmissionError) as e:
            fe.enqueue(hexg, req())
        record["error"] = str(e.value)
    elif case == "shed":
        fe = frontend(pkg, max_pending=2, admission="shed")
        t1 = fe.enqueue(hexg, req(priority=5))
        t2 = fe.enqueue(hexg, req(priority=3))
        t3 = fe.enqueue(hexg, req(priority=1))        # least urgent: shed on arrival
        record["arrival"] = (t3.state, t3.done())
        with pytest.raises(pkg.serve.AdmissionError) as e:
            t3.result()
        record["error"] = str(e.value)
        t4 = fe.enqueue(hexg, req(priority=9))        # outranks t2: t2 is shed
        record["outranked"] = (t2.state, t4.state, fe.pending)
        keep = [t1, t4]
    else:
        fe = frontend(pkg, tenant_quota=1)
        keep = [fe.enqueue(hexg, req(tenant="a"))]
        with pytest.raises(pkg.serve.AdmissionError) as e:
            fe.enqueue(hexg, req(tenant="a"))
        record["error"] = str(e.value)
        keep.append(fe.enqueue(hexg, req(tenant="b")))   # another tenant is admitted
    record["stats"] = stats_record(fe)
    if pkg is PORT:
        out = fe.drain(keep)
        assert fe.pending == 0
        want = result_record(solo(pkg, fe, hexg, {}))
        assert all(result_record(out[t]) == want for t in keep)
        if case == "quota":
            assert fe.stats.by_tenant["a"]["completed"] == 1
            assert fe.submit(hexg, req(tenant="a")).result()  # the quota freed up
        else:
            assert fe.submit(hexg, req()).result() is not None
    return record


@pytest.mark.parametrize("case", ["reject", "shed", "quota"])
def test_admission_control(case):
    rec = both(_admission_scenario, case=case)
    if case == "reject":
        assert rec["pending"] == 2 and "pending queue full" in rec["error"]
        assert rec["stats"]["rejected"] == 1
    elif case == "shed":
        assert rec["arrival"] == ("shed", True) and "shed" in rec["error"]
        assert rec["outranked"] == ("shed", "queued", 2)
        assert (rec["stats"]["shed"], rec["stats"]["rejected"]) == (2, 0)
    else:
        assert "tenant 'a'" in rec["error"]
        assert rec["stats"]["by_tenant"]["a"] == {
            "admitted": 1, "completed": 0, "rejected": 1, "shed": 0}


def test_legacy_dict_requests_warn_once(monkeypatch):
    messages = {}
    for name, mod in (("repro", j_coloring), ("port", t_coloring)):
        monkeypatch.setattr(mod, "_LEGACY_WARNED", False)
        with pytest.warns(DeprecationWarning, match="dict coloring requests") as w:
            req = mod.as_request({"color_mask": None})
        messages[name] = str(w[0].message)
        assert isinstance(req, mod.ColoringRequest)
        with warnings.catch_warnings():
            warnings.simplefilter("error")            # once per process:
            mod.as_request({"seed": None})            # no second warning
            mod.as_request(priority=1)                # kwargs never warn
        with pytest.raises(TypeError, match="unknown request keys"):
            mod.as_request({"mask": None})
    assert messages["port"] == messages["repro"].replace("repro.serve", "repro_torch.serve")


def test_reduce_plan_resolved_once_across_requests():
    svc = t_serve.ColoringService(PORT.pgs["hex"], cache=False, reduce_passes=2,
                                  **PORT.kw)
    svc.submit()
    cache = svc._frontend.cache
    rplans = [p for p in cache.plans() if isinstance(p, t_reduce.ReductionPlan)]
    assert len(rplans) == 1                           # resolved once, cached
    rplan = rplans[0]
    probes, n_entries = (rplan.stats.traces, rplan.stats.compiles), len(cache)
    svc.submit()
    svc.run_batch([{}, {}])
    assert (rplan.stats.traces, rplan.stats.compiles) == probes
    assert len(cache) == n_entries


def test_named_sparse_exchange_scatters_with_the_kernel_and_batches(monkeypatch):
    """``sparse_delta`` named under a kernel backend scatters received pairs
    with ``pair_scatter`` (its plain version on the CPU); the plan key holds
    the two names, so the frontend batches each topology's requests on one
    cached plan.  An instance keeps its own ``scatter``."""
    import repro_torch.core.exchange as t_exchange
    from repro_torch.kernels.scatter import pair_scatter_ref

    assert t_exchange.get_exchange("sparse_delta", "cuda_fused").scatter == "cuda"
    assert t_exchange.get_exchange("hier_delta", "cuda").scatter == "cuda"
    assert t_exchange.get_exchange("sparse_delta").scatter == "reference"
    instance = t_exchange.SparseDeltaExchange()
    assert t_exchange.get_exchange(instance, "cuda_fused").scatter == "reference"
    calls = []
    monkeypatch.setattr(t_exchange, "pair_scatter",
                        lambda *a: calls.append(1) or pair_scatter_ref(*a))
    fe = frontend(PORT, backend="cuda_fused", exchange="sparse_delta", max_batch=4)
    pairs = [(PORT.pgs[k], {}) for k in ("hex", "grid")] * 3
    results = fe.run_stream(pairs)
    assert len(fe._groups) == 2 and fe.stats.batches == 2 and len(fe.cache) == 2
    assert all(g.plan._strategy.scatter == "cuda" for g in fe._groups.values())
    assert calls
    for (pg, req), res in zip(pairs, results):
        assert result_record(res) == result_record(solo(PORT, fe, pg, req))


# ---------------------------------------------------------------------------
# The CLI: --stream and --repeat print what repro's CLI prints.
# ---------------------------------------------------------------------------

def _stream_fields(out: str) -> dict:
    """The topology, ``refills=`` and per-topology result words of a
    ``--stream`` run (times and rates left out)."""
    fields = {}
    for line in out.splitlines():
        words = line.split()
        if line.startswith("[color] topology "):
            fields["topology", words[2]] = words[3:]
        elif line.startswith("[color] stream "):
            fields["stream"] = words[2:4] + [w for w in words if w.startswith("refills=")]
        elif line.startswith("[color]   "):
            fields["result", words[1]] = words[2:]
    return fields


def _run_cli(main, argv, monkeypatch, capsys, *, port: bool) -> str:
    if port:
        main(argv + ["--device", "cpu"])
    else:
        monkeypatch.setattr(sys, "argv", ["color"] + argv)
        main()
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--stream", "hex:6,4,4|grid:12,12", "--requests", "6"],
    ["--stream", "hex:6,4,4|grid:12,12", "--requests", "18", "--parts", "2",
     "--backend", "cuda_fused", "--exchange", "sparse_delta"],
])
def test_cli_stream_prints_what_repro_prints(argv, monkeypatch, capsys):
    want = _run_cli(j_cli.main, [a.replace("cuda_fused", "reference") for a in argv],
                    monkeypatch, capsys, port=False)
    got = _run_cli(t_cli.main, argv, monkeypatch, capsys, port=True)
    assert _stream_fields(got) == _stream_fields(want) and _stream_fields(got)
    assert "req/s cold=" in got and "warm=" in got


def test_cli_repeat_through_the_service(monkeypatch, capsys):
    argv = ["--graph", "hex:6,4,4", "--parts", "3", "--repeat", "3"]
    want = _run_cli(j_cli.main, argv, monkeypatch, capsys, port=False)
    got = _run_cli(t_cli.main, argv + ["--backend", "reference"], monkeypatch, capsys,
                   port=True)

    def fields(out):
        [line] = [ln for ln in out.splitlines() if " proper=" in ln]
        repeat = [ln for ln in out.splitlines() if "repeat=" in ln]
        return ([w for w in line.split() if not w.startswith(("time=", "(device"))],
                [w for ln in repeat for w in ln.split()
                 if w.startswith(("repeat=", "engine=", "("))])

    assert fields(got) == fields(want)
    assert "(2 programs, paid once)" not in got       # one plan, one first run
    assert "(1 programs, paid once)" in got and "(mean execution of 3 timesteps)" in got


def test_cli_stream_exits_1_when_the_warm_replay_diverges():
    """The CLI process exits 1 when the warm replay differs from the cold
    one (here made to differ: the second replay's first result is
    changed)."""
    code = (
        "import repro_torch.launch.color as cli\n"
        "import repro_torch.serve.coloring as c\n"
        "run_stream, calls = c.ColoringFrontend.run_stream, []\n"
        "def diverging(self, pairs):\n"
        "    out = run_stream(self, pairs)\n"
        "    calls.append(out)\n"
        "    if len(calls) == 2:\n"
        "        out[0].colors = out[0].colors + 1\n"
        "    return out\n"
        "c.ColoringFrontend.run_stream = diverging\n"
        "cli.main(['--stream', 'hex:6,4,4|grid:12,12', '--requests', '4',\n"
        "          '--parts', '3', '--device', 'cpu'])\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 1, out.stderr
    assert "warm replay diverged for hex_6x4x4" in out.stderr


def test_cli_needs_a_graph_or_a_stream(capsys):
    with pytest.raises(SystemExit) as e:
        t_cli.main(["--parts", "3", "--device", "cpu"])
    assert e.value.code == 2
    assert "one of --graph or --stream is required" in capsys.readouterr().err


def test_cli_stream_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cli.main(["--stream", "hex:6,4,4", "--requests", "1", "--parts", "2"])
