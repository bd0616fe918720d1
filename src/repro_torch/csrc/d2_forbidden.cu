// Net-based two-hop color assignment (distance-2 VB_BIT) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/d2_forbidden.py::_d2_kernel
// (wrapper d2_forbidden) together with the pick of
// src/repro/kernels/ops.py::d2_assign_pallas, which is the function the
// main path calls. Same function, on the stacked part axis:
//
//   for each part p and row r that is active and uncolored:
//     mask = OR of the window bits over [base, base + 32) of
//            tab[p, u]          for each one-hop lane u = adj[p, r, k]
//                               (skipped when partial_d2), and
//            tab[p, ext[p, u, j]] for every lane j of row u of the
//                               extended adjacency (the two-hop colors)
//     full mask  -> color stays 0, base += 32
//     else       -> color = base + (index of the lowest clear bit)
//   every other row keeps its color and base.
//
// What bounds it on the H100: memory. Per row to color it reads W int32
// adjacency entries, W rows of W int32 extended-adjacency entries and
// gathers up to W + W*W table entries; every row reads color, base and
// active and writes color and base. There is no arithmetic worth counting.
//
// Design: one thread per (part, row), grid (ceil(N / 256), P), as
// vb_bit.cu. The two-hop colors are reached through the (N + G + 1, W)
// extended adjacency, net by net, so the assignment never reads the
// (P, N, W*W) two_hop_cidx table the collision test uses. Rows that are
// not active and uncolored skip the adjacency entirely. The mask lives in
// a register and the pick is coloring.cuh's, shared with vb_bit.cu. The
// ragged tail of the last block is masked by the row bound, so no input is
// padded.
#include <cstdint>
#include <cuda_runtime.h>

#include "coloring.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void d2_assign_kernel(const int32_t* __restrict__ adj,
                                 const int32_t* __restrict__ ext,
                                 const int32_t* __restrict__ base, int64_t base_ps,
                                 const uint8_t* __restrict__ active, int64_t active_ps,
                                 const int32_t* __restrict__ tab, int64_t tab_ps,
                                 int32_t* __restrict__ out_colors,
                                 int32_t* __restrict__ out_base,
                                 int n, int n_tab, int w, bool partial_d2) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int64_t p = blockIdx.y;
  if (r >= n) return;
  const int32_t* t = tab + p * tab_ps;
  const int32_t c = t[r];                       // the table's owned segment
  const int32_t b = base[p * base_ps + r];
  const int64_t out = p * n + r;
  if (!(active[p * active_ps + r] != 0 && c == 0)) {
    out_colors[out] = c;
    out_base[out] = b;
    return;
  }
  const int32_t* row = adj + out * w;
  const int32_t* e = ext + p * n_tab * w;
  uint32_t mask = 0u;
  for (int k = 0; k < w; ++k) {
    const int32_t u = row[k];
    if (!partial_d2) mask |= coloring::window_bit(t[u], b);
    const int32_t* net = e + static_cast<int64_t>(u) * w;
    for (int j = 0; j < w; ++j) mask |= coloring::window_bit(t[net[j]], b);
  }
  int32_t color, next_base;
  coloring::pick_color(mask, b, color, next_base);
  out_colors[out] = color;
  out_base[out] = next_base;
}

}  // namespace

// Row arrays (base, active) and the table may be strided over the part
// axis; their row axis is contiguous. The rows' current colors are the
// table's first n entries. adj is a contiguous (P, N, W) array, ext a
// contiguous (P, n_tab, W) array; outputs are contiguous (P, N).
// Returns cudaGetLastError() after the launch.
extern "C" int d2_assign_launch(const void* adj, const void* ext,
                                const void* base, long long base_ps,
                                const void* active, long long active_ps,
                                const void* tab, long long tab_ps,
                                void* out_colors, void* out_base,
                                int n_parts, int n, int n_tab, int w,
                                int partial_d2, void* stream) {
  if (n_parts == 0 || n == 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads, n_parts);
  d2_assign_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(adj), static_cast<const int32_t*>(ext),
      static_cast<const int32_t*>(base), base_ps,
      static_cast<const uint8_t*>(active), active_ps,
      static_cast<const int32_t*>(tab), tab_ps,
      static_cast<int32_t*>(out_colors), static_cast<int32_t*>(out_base),
      n, n_tab, w, partial_d2 != 0);
  return static_cast<int>(cudaGetLastError());
}
