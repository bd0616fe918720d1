"""Conflict-resolution rules (paper Algorithm 4, ``Check-Conflicts``).

The loser of a conflicting pair is decided by a *pure function* of
(color, degree, hash(GID), GID), so any two parties — rows of one part or
two parts across the stacked part axis — reach the same verdict with zero
communication.  The rule is bit-identical to Algorithm 4:

  1. colors equal and nonzero, else no conflict;
  2. if ``recolor_degrees``: the *lower-degree* endpoint loses;
  3. tie → the endpoint with the *higher* ``rand(GID)`` loses;
  4. tie → the endpoint with the higher GID loses.

Eager PyTorch has no unsigned 32-bit shifts or compares on the CPU, so the
hash is computed in int64 holding values below ``2**32``; the multiplies
are split so that no intermediate leaves int64's range.
"""
from __future__ import annotations

import torch

__all__ = ["gid_hash", "v_loses"]

MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in ``[0, 2**32)``.

    ``x * c`` can reach ``2**64``; splitting ``c`` into 16-bit halves keeps
    each partial product below ``2**48``.
    """
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def gid_hash(gid: torch.Tensor) -> torch.Tensor:
    """``rand(GID)``: deterministic avalanche hash (lowbias32 variant).

    Returns int64 values in ``[0, 2**32)``, equal to the uint32 hash.
    """
    x = gid.to(torch.int64) & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def v_loses(
    color_v: torch.Tensor,
    color_u: torch.Tensor,
    deg_v: torch.Tensor,
    deg_u: torch.Tensor,
    gid_v: torch.Tensor,
    gid_u: torch.Tensor,
    *,
    recolor_degrees: bool,
) -> torch.Tensor:
    """True where vertex ``v`` must be uncolored in the pair ``(v, u)``.

    Broadcasting Algorithm 4 from v's perspective.  ``u``'s owner evaluates
    the mirrored call and reaches the complementary verdict.  Self-pairs
    (``gid_v == gid_u``) are never conflicts.
    """
    conflict = (color_v == color_u) & (color_v > 0) & (gid_v != gid_u)
    hv, hu = gid_hash(gid_v), gid_hash(gid_u)
    loses = torch.where(hv != hu, hv > hu, gid_v > gid_u)
    if recolor_degrees:
        loses = torch.where(deg_v != deg_u, deg_v < deg_u, loses)
    return conflict & loses
