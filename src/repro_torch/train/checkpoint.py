"""Checkpointing with atomic commit and an async writer.

The counterpart of ``repro/train/checkpoint.py``, in its on-disk layout:

  <dir>/step_<n>/manifest.json       keys, shapes, dtypes, extra
  <dir>/step_<n>/arrays.npz          the leaves, keys joined with ``/``

Commit is atomic: written to ``step_<n>.tmp`` then renamed, so a crash
mid-write never corrupts the latest checkpoint.  A bfloat16 leaf is
written as its 2-byte bits (numpy voids ``V2``, as ``np.savez`` writes
``repro``'s ml_dtypes leaves) with ``"bfloat16"`` in the manifest, and is
read back by its bits (``repro``'s ``restore`` cannot cast those voids).  So
a checkpoint written by ``repro`` restores here, and a float32 one written
here restores in ``repro``: this is how weights and optimizer state cross
from one package to the other.

On a mesh (DTensor leaves) every rank of the mesh gathers each leaf whole
(``full_tensor()``, a collective, on the caller's thread) and the mesh's
first rank writes ``repro``'s layout; ``restore`` reads on every rank and
distributes each leaf onto the target leaf's mesh and placements, whatever
mesh wrote the checkpoint: ``repro``'s elastic restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.launch.mesh import leads
from repro_torch.train.tree import flatten, map_with_path, whole

_BF16_BITS = np.dtype("V2")


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _to_host(t: torch.Tensor, keep: bool = True) -> np.ndarray | None:
    """A host copy of ``t`` as numpy (bfloat16 as its bits), never a view
    of a tensor that a later step updates in place; a DTensor whole (every
    rank of its mesh gathers it; a rank that does not ``keep`` it copies
    nothing to the host and gets None)."""
    t = whole(t.detach())
    if not keep:
        return None
    t = t.to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BITS)
    return t.numpy()


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == _BF16_BITS else str(a.dtype)


def writes(tree) -> bool:
    """Whether this rank writes ``tree``: the first rank of the mesh of its
    DTensor leaves, every process for a tree without them."""
    for t in flatten(tree).values():
        if _is_dtensor(t):
            return leads(t.device_mesh)
    return True


def mesh_barrier(mesh) -> None:
    """Return once every rank of ``mesh`` has called it: one all-reduce of
    a word on each mesh dim's group, in turn."""
    import torch.distributed as dist

    word = torch.zeros(1, device=mesh.device_type)
    for i in range(mesh.ndim):
        dist.all_reduce(word, group=mesh.get_group(i))


def save(ckpt_dir: str, step: int, tree, *, extra: dict | None = None) -> str | None:
    """Synchronous atomic save of a tree of tensors or numpy arrays.
    Returns the committed path (None on a rank of a mesh that does not
    write)."""
    write = writes(tree)
    flat = {k: v if isinstance(v, np.ndarray) else _to_host(v, write)
            for k, v in flatten(tree).items()}
    if not write:
        return None
    return _commit(ckpt_dir, step, flat, extra)


def _commit(ckpt_dir: str, step: int, flat: dict, extra: dict | None) -> str:
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: _dtype_name(v) for k, v in flat.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


class AsyncCheckpointer:
    """Off-step-path writer: ``save`` returns once the leaves are on the
    host; ``wait`` joins.

    The device-to-host copy happens on the caller's thread (so the next
    step may update the tensors in place); serialization happens on the
    worker.
    """

    def __init__(self):
        self._thread: threading.Thread | None = None
        self.last_path: str | None = None

    def save(self, ckpt_dir: str, step: int, tree, *, extra=None):
        write = writes(tree)
        flat = {k: _to_host(t, write) for k, t in flatten(tree).items()}
        self.wait()
        if not write:
            return

        def work():
            self.last_path = _commit(ckpt_dir, step, flat, extra)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, target_tree, *, device=None):
    """Restore into the structure, dtypes and devices of ``target_tree`` (a
    tree of tensors; ``device``, where given, for every leaf); a DTensor
    target leaf's value is distributed onto its mesh and placements.
    Returns (tree, the manifest's ``extra``)."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    flat_target = flatten(target_tree)
    missing = set(flat_target) - set(manifest["keys"])
    if missing:
        raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")

    def load(k, tgt):
        arr = data[k]
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(f"shape mismatch for {k}: {arr.shape} vs {tuple(tgt.shape)}")
        if manifest["dtypes"][k] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        if _is_dtensor(tgt):
            from torch.distributed.tensor import distribute_tensor

            return distribute_tensor(t.to(device=tgt.device, dtype=tgt.dtype),
                                     tgt.device_mesh, tgt.placements, src_data_rank=None)
        return t.to(device=tgt.device if device is None else device, dtype=tgt.dtype)

    return map_with_path(load, target_tree), manifest["extra"]
