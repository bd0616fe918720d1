"""A configuration, a traffic mix and a per-layer metric added as new files
only, in a copy of the benchmark, are found by name; no file that was
there changes."""
import hashlib
import json
import shutil
import time

from bench import harness


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_from_new_files_only(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "bench")
    bench_dir = tmp_path / "bench"
    config = harness.load_json(bench_dir / "configs" / "hex252_d1.json")
    config.update(graph={"generator": "hex_mesh", "dims": [12, 6, 6]}, n_parts=3,
                  source="a smaller slab mesh")
    (bench_dir / "configs" / "hex_small_d1.json").write_text(json.dumps(config))
    (bench_dir / "traffic" / "half.json").write_text(json.dumps(
        {"entry": "plan_run", "recolor_fraction": 0.5}))
    (bench_dir / "metrics" / "requests_traced.py").write_text(
        "def read(record):\n    return float(record['requests'])\n")
    bench = harness.load_benchmark(tmp_path)
    bench["configs"].append({"name": "hex_small_d1", "source": "a smaller slab mesh",
                             "file": "bench/configs/hex_small_d1.json", "reduced": [],
                             "why": "test"})
    cell = {"name": "hex_small_d1.half", "config": "hex_small_d1", "traffic": "half",
            "chips": 1, "why": "test"}
    bench["workloads"].append(cell)
    bench["per_layer"].append({"name": "requests_traced", "unit": "requests",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry point", "moves": "colorings_per_s",
                               "workloads": [cell["name"]]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    line = harness.run_cell(cell, seed=5, seconds=0.3, trace=True, device="cpu",
                            t_start=time.perf_counter(), bench=bench, bench_dir=bench_dir)
    assert line["correct"], line["checks"]
    assert line["metrics"]["requests_traced"]["value"] == line["attempted"] > 0
    after = _digests(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        p.relative_to(bench_dir) for p in (bench_dir / "configs" / "hex_small_d1.json",
                                           bench_dir / "traffic" / "half.json",
                                           bench_dir / "metrics" / "requests_traced.py")}
