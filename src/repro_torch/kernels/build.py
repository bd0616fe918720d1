"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in :func:`build_dir` (the checkout's git-ignored ``build/``,
or the directory ``$REPRO_TORCH_BUILD_DIR`` names) under a name that
carries a hash of its source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header is rebuilt
and an unchanged one is loaded as it is.  :func:`build` starts
one ``nvcc`` per missing library, all at once, and waits for them all.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "build", "build_dir", "load", "nvcc_path", "ptxas_report"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR_ENV = "REPRO_TORCH_BUILD_DIR"
SOURCES = ("vb_bit", "conflict", "d2_forbidden", "fused_round", "pair_scatter",
           "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str | None:
    """``nvcc`` from ``CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    return None


def build_dir() -> Path:
    """Where the libraries are built: ``$REPRO_TORCH_BUILD_DIR`` if set,
    else ``build/`` at the root of the checkout that holds ``src/repro_torch``.

    Raises ``RuntimeError`` when the package does not run from a checkout
    and no directory is named, rather than writing beside an installation.
    """
    if os.environ.get(BUILD_DIR_ENV):
        return Path(os.environ[BUILD_DIR_ENV])
    root = CSRC.parents[2]
    if CSRC.parents[1].name != "src" or not (root / "pyproject.toml").is_file():
        raise RuntimeError(
            f"repro_torch does not run from a source checkout ({CSRC}); set "
            f"{BUILD_DIR_ENV} to the directory the CUDA kernels are built in")
    return root / "build"


def _lib_path(name: str) -> Path:
    h = hashlib.blake2b(digest_size=8)
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # every source includes them
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every library of ``names`` that is not built yet, in parallel.

    Returns ``{name: library path}``.  Raises ``RuntimeError`` with the
    compiler's output when ``nvcc`` is missing or a build fails.
    """
    out = {name: _lib_path(name) for name in names}
    todo = {name: path for name, path in out.items() if not path.is_file()}
    if not todo:
        return out
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels cannot be built")
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu exited {proc.returncode}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)       # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def ptxas_report(name: str) -> str:
    """The compiler's register and shared-memory report for one library."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        _LOADED[name] = lib
    return lib
