"""The paper's weak-scaling hexahedral mesh, renumbered from the seed.

A frozen copy of the port's ``hex_mesh`` generator (a 3D grid of cells,
6-point stencil, x-major ids so that contiguous blocks are slabs along x),
kept here so that no later change to the program moves the benchmark's
input, and written in torch so that it runs on the card in a few large
calls.  It gives ELL rows instead of CSR: ``ell[v]`` holds ``v``'s
neighbours (``-1`` past its degree), lanes ``-x, -y, -z, +z, +y, +x``.

``make`` then renumbers the vertices at random within each of the
``n_parts`` slabs that a block partition of ``n_parts`` parts cuts: the
slab bounds stay, so the partition, its ghosts and its slab layout are the
paper's, while the numbering inside a slab is as arbitrary as an
unstructured mesh's.  Each seed is a different coloring problem: the
conflict rule breaks ties by a hash of the global ids.
"""
from __future__ import annotations

import numpy as np
import torch

PAD = -1


def hex_mesh_ell(nx: int, ny: int, nz: int, device="cpu") -> torch.Tensor:
    """``(nx·ny·nz, 6)`` int32 neighbour lanes of the hexahedral mesh."""
    n = nx * ny * nz
    ids = torch.arange(n, dtype=torch.int32, device=device).reshape(nx, ny, nz)
    x = torch.arange(nx, device=device)[:, None, None]
    y = torch.arange(ny, device=device)[None, :, None]
    z = torch.arange(nz, device=device)[None, None, :]
    steps = ((x > 0, -ny * nz), (y > 0, -nz), (z > 0, -1),
             (z < nz - 1, 1), (y < ny - 1, nz), (x < nx - 1, ny * nz))
    return torch.stack([torch.where(inside, ids + step, PAD) for inside, step in steps],
                       dim=-1).reshape(n, len(steps))


def slab_bounds(n: int, n_parts: int) -> np.ndarray:
    """The ``n_parts + 1`` bounds of a block partition into slabs."""
    return np.linspace(0, n, n_parts + 1).astype(np.int64)


def renumber_within_slabs(ell: torch.Tensor, n_parts: int, seed: int) -> torch.Tensor:
    """``ell`` with every id replaced by a random new id of the same slab;
    row ``new_of[v]`` of the result holds the neighbours of old row ``v``."""
    dev = ell.device
    gen = torch.Generator(device=dev).manual_seed(seed % 2**64)
    bounds = slab_bounds(ell.shape[0], n_parts).tolist()
    new_of = torch.cat([lo + torch.randperm(hi - lo, generator=gen, device=dev)
                        for lo, hi in zip(bounds[:-1], bounds[1:])]).to(torch.int32)
    out = torch.empty_like(ell)
    out[new_of.long()] = torch.where(ell >= 0, new_of[ell.clamp(min=0).long()], PAD)
    return out


def make(spec: dict, n_parts: int, seed: int, device="cpu") -> torch.Tensor:
    """The mesh that ``spec`` names (``{"dims": [nx, ny, nz]}``), renumbered
    within the slabs of ``n_parts`` parts from ``seed``, on ``device``."""
    return renumber_within_slabs(hex_mesh_ell(*spec["dims"], device=device), n_parts, seed)
