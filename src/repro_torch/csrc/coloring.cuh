// Device math shared by every coloring kernel of the port.
//
// The kernels must agree bit for bit with each other and with the plain
// PyTorch versions (repro_torch/core/conflict.py, core/local.py), so the
// hash, the Algorithm-4 loser rule and the VB_BIT window pick live here
// once: vb_bit.cu, conflict.cu, d2_forbidden.cu, collision.cu and
// fused_round.cu include this header.
#pragma once

#include <cstdint>

namespace coloring {

// rand(GID): the lowbias32 avalanche hash of core/conflict.py::gid_hash.
__device__ __forceinline__ uint32_t gid_hash(int32_t gid) {
  uint32_t x = static_cast<uint32_t>(gid);
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Algorithm 4 for a pair (v, u) whose colors collide and whose gids
// differ: true where v loses. The lower degree loses; equal degrees fall
// to the higher gid_hash, then the higher gid. Callers without
// recolor_degrees pass du == dv, so the degree never decides. hv is
// gid_hash(gv), computed once per row by the caller.
__device__ __forceinline__ bool v_loses(int32_t dv, int32_t du, uint32_t hv,
                                        int32_t gv, int32_t gu) {
  if (du != dv) return dv < du;
  const uint32_t hu = gid_hash(gu);
  return (hv != hu) ? (hv > hu) : (gv > gu);
}

// The bit a neighbor color forbids in the window [base, base + 32); 0 for
// an uncolored neighbor or a color outside the window.
__device__ __forceinline__ uint32_t window_bit(int32_t color, int32_t base) {
  const int32_t rel = color - base;
  return (color > 0 && rel >= 0 && rel < 32) ? (1u << rel) : 0u;
}

// VB_BIT pick: the lowest clear bit of the forbidden mask as a color of the
// window. A full mask leaves the row uncolored (0) and moves its window up
// by 32.
__device__ __forceinline__ void pick_color(uint32_t mask, int32_t base,
                                           int32_t& color, int32_t& next_base) {
  if (mask == 0xFFFFFFFFu) {
    color = 0;
    next_base = base + 32;
  } else {
    color = base + (__ffs(~mask) - 1);
    next_base = base;
  }
}

}  // namespace coloring
