"""Every cell run end to end through the harness on a tiny mesh, on the CPU
with the kernels' plain versions (the four-card cell as four gloo
processes), and the shape of the line it prints."""
import io
import json
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest

from bench import harness
from bench.tests._cells import CELLS, cell, mix

BENCH = harness.load_benchmark()
TINY = {"graph": {"dims": [12, 8, 8]}}  # 2 x-planes a part of 6
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(name, trace, seconds=0.5, seed=2**31 + 3, **kw):
    return harness.run_cell(cell(name), seed=seed, seconds=seconds, trace=trace, device="cpu",
                            t_start=time.perf_counter(), overrides=TINY, mix=mix(name), **kw)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_end_to_end(name):
    this = cell(name)
    line = run(name, trace=False)
    assert line["correct"], line["checks"]
    assert list(line) == KEYS + ["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    want = [m["name"] for m in BENCH["end_to_end"] if harness.applies(m, this)]
    assert sorted(line["metrics"]) == sorted(want)
    assert line["device"]["count"] == this["chips"]
    traced = run(name, trace=True)
    assert traced["correct"], traced["checks"]
    assert list(traced) == KEYS + ["breakdown", "checks"]
    assert set(traced["device"]) >= {"busy_s", "window_s", "memory_peak_bytes"}
    layer = {m["name"] for m in BENCH["per_layer"] if harness.applies(m, this)}
    # The device's numbers need a card; every other reader finds its number.
    device_only = {"device_ms_per_request", "coloring_roofline_share",
                   "device_idle_share", "host_syncs_per_request"}
    assert layer - device_only <= set(traced["metrics"]) <= layer
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}


def test_partial_mix_keeps_each_compared_requests_start():
    """In a partial mix every compared request starts from the answer of a
    request that is compared too (or from the chain's cold start)."""
    from bench.kinds import coloring
    from repro_torch.graph.partition import partition_graph

    config = harness.merged(harness.load_json(harness.BENCH / "configs" / "hex252_d1.json"), TINY)
    ell, graph = coloring.make_inputs(config, 11, "cpu")
    pg = partition_graph(graph, config["n_parts"])
    prog = coloring.session(pg, ell.shape[0], config, mix("hex252_d1.timesteps"), seed=11,
                            seconds=0.5, trace=False, device="cpu",
                            t_start=time.perf_counter())
    coloring._free_program()
    ks = [x.k for x in prog["kept"]]
    assert prog["attempted"] > coloring.SAMPLE + 1 and len(ks) == len(set(ks))
    assert max(ks) == prog["attempted"] - 1
    by_k = {x.k: x for x in prog["kept"]}
    assert all(x.k - 1 in by_k or x.k + 1 in by_k for x in prog["kept"])
    sampled = [x for x in prog["kept"] if x.k - 1 in by_k]
    assert len(sampled) >= coloring.SAMPLE + 1
    for x in sampled:
        assert (x.colors0 == by_k[x.k - 1].result.colors * ~x.mask).all()


def test_last_lines():
    line = run("hex252_d1.cold", trace=False)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        harness.emit(line)
    last = json.loads(out.getvalue().splitlines()[-1])
    assert list(last) == KEYS + ["checks"] and last == line
    tail = err.getvalue().splitlines()[-len(line["checks"]):]
    assert tail == [f"check {k} {c['value']} limit {c['limit']}"
                    for k, c in line["checks"].items()]


def test_every_metric_belongs_to_a_cell_and_moves_a_reported_one():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for c in BENCH["workloads"]:
        names = {m["name"] for m in BENCH["end_to_end"] if harness.applies(m, c)}
        assert "setup_s" in names and len(names) >= 2
        assert any(harness.applies(m, c) for m in BENCH["per_layer"])
    used = {c["config"] for c in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["workloads"]:
        assert cell(c["name"]) == {k: c[k] for k in ("name", "config", "traffic", "chips")}


@pytest.mark.cuda
def test_cell_on_the_card():
    """The cold d1 cell on a small mesh through the CUDA kernels."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    line = harness.run_cell(cell("hex252_d1.cold"), seed=5, seconds=1.0, trace=True, device="cuda",
                            t_start=time.perf_counter(),
                            overrides={"graph": {"dims": [64, 64, 64]}})
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
