"""Import hygiene of the benchmark: nothing under ``bench/`` imports JAX or
the JAX package ``repro`` (top-level names compared whole: ``repro_torch``
is not ``repro``), the reference imports nothing of the port either, and
nothing under ``bench/`` reads ``repro``'s ``benchmarks/``."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _tops(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module",) and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def _forbidden(path: Path, reference: bool) -> set[str]:
    banned = {"jax", "jaxlib", "flax", "repro"} | ({"repro_torch"} if reference else set())
    return set(_tops(path)) & banned


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_imports(path):
    bad = _forbidden(path, BENCH / "reference" in path.parents)
    assert not bad, f"{path.relative_to(BENCH)} imports {bad}"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_reads_the_jax_benchmarks(path):
    if path == Path(__file__).resolve():
        return
    assert "benchmarks" not in path.read_text()


def test_the_check_catches_them(tmp_path):
    bad = tmp_path / "x.py"
    bad.write_text("import jax.numpy\nfrom repro.core import plan\nimport flax\n"
                   "from repro_torch.core import plan as p\nimport torch\n"
                   "importlib.import_module('jaxlib.xla')\n")
    assert _forbidden(bad, reference=False) == {"jax", "repro", "flax", "jaxlib"}
    assert _forbidden(bad, reference=True) == {"jax", "repro", "flax", "jaxlib",
                                               "repro_torch"}
