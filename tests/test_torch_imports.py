"""Import hygiene of the PyTorch port and its device rule.

``src/repro_torch``, ``chip_smoke.py`` and the card-only tests run on a
machine without JAX, so none may import ``jax`` or anything of the JAX
package ``repro``.
Entry points run on ``cuda`` unless asked for the CPU, and without a card
they raise instead of falling back.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
# The card-only tests run on the card's machine too, which has no JAX, and
# the gloo ranks of the engine's and the sharded stack's tests start on
# torch alone.
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_kernels_card.py",
                 ROOT / "tests" / "_shard_map_ranks.py", ROOT / "tests" / "_sharded_ranks.py"])


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_roofline_is_among_the_port_files():
    """The roofline analysis runs in the card's machine too (chip_smoke's
    ``[roofline]`` lines): its modules are held to the same rule."""
    roofline = ROOT / "src" / "repro_torch" / "roofline"
    assert {roofline / "__init__.py", roofline / "analysis.py"} <= set(PORT_FILES)


def test_hygiene_check_catches_forbidden_imports(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.core import plan\n"
                 "from repro_torch.core import plan as ok\nimport torch\n")
    assert [m for m in _imported_modules(f) if _forbidden(m)] == [
        "jax.numpy", "repro.core"]


def test_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.core.distributed import color_distributed
    from repro_torch.graph.generators import hex_mesh
    from repro_torch.graph.partition import partition_graph
    from repro_torch.configs import get_smoke
    from repro_torch.launch import color as cli
    from repro_torch.launch import train as train_cli
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pg = partition_graph(hex_mesh(4, 4, 4), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        color_distributed(pg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--graph", "hex:4,4,4", "--parts", "2"])
    assert color_distributed(pg, device="cpu").converged
    cfg = get_smoke("tinyllama_1_1b")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, params, batch=1, max_len=8)
    out = ServeEngine(cfg, params, batch=1, max_len=8, device="cpu").generate(
        [np.arange(1, 4, dtype=np.int32)], max_new_tokens=2)
    assert len(out) == 1 and len(out[0]) == 2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.train_loop(cfg, steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--arch", "tinyllama_1_1b", "--smoke", "--steps", "1"])
    _, hist = train_cli.train_loop(cfg, steps=1, global_batch=2, seq_len=8, device="cpu")
    assert len(hist) == 1


def test_chip_smoke_refuses_without_a_card(monkeypatch, capsys):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory without the repo, the script cannot find
    the port and exits non-zero with no result line, even with a card."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    code = ("import runpy, sys, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "sys.argv = ['chip_smoke.py']\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "repro_torch" in out.stderr
    assert '"ok"' not in out.stdout
