// Net-based two-hop color assignment (distance-2 VB_BIT) for Hopper (sm_90a),
// over a list of the rows to color.
//
// Replaces the TPU kernel src/repro/kernels/d2_forbidden.py::_d2_kernel
// (wrapper d2_forbidden) together with the pick of
// src/repro/kernels/ops.py::d2_assign_pallas, which is the function the
// main path calls. The same function, restricted to the listed rows of the
// stacked part axis:
//
//   for each entry e = p * N + r of rows (an active uncolored row):
//     mask = OR of the window bits over [b, b + 32), b = base[e], of
//            tab[p, u]          for each one-hop lane u = adj[p, r, k]
//                               (skipped when partial_d2), and
//            tab[p, ext[p, u, j]] for every lane j of row u of the
//                               extended adjacency (the two-hop colors)
//     full mask  -> newc[e] = 0, base[e] = b + 32
//     else       -> newc[e] = b + (index of the lowest clear bit), base[e] = b
//   rows that are not listed are neither read nor written.
//
// What bounds it on the H100: memory. Per listed row it reads its entry
// and base, W int32 adjacency entries, W rows of W int32 extended-adjacency
// entries, and gathers up to W + W*W table entries; it writes newc and
// base. There is no arithmetic worth counting.
//
// Design: one thread per entry of the list, a flat grid over the list
// (the caller knows its length: the fixed point's stop test reads it).
// - Only listed rows cost anything: late in a fixed point, and on a warm
//   request, a few rows are listed where the launch used to walk all P * N.
// - The result goes to newc and base, never into the table the launch
//   reads: a listed row may be another's neighbor, and every row must read
//   the iteration-start colors, so the result is the same in any order.
// - Two bodies, picked per launch by what the list shows: a dense list (at
//   least a quarter of the P * N rows: a cold request's first iterations)
//   saturates the memory system, and there the fewest load instructions win:
//   the neighbours two at a time, their extended-adjacency rows read as
//   8-byte pairs. A sparse list (a warm request, a late iteration) leaves
//   the card waiting on memory, and there the most loads in flight win:
//   three neighbours at a time, eight entries of each one's row read
//   together, then their 24 table entries gathered together; its guards
//   take any w, so it also serves a dense list with an odd w (or an ext
//   array that is not 8-byte aligned). PERF.md has both bodies' times on a
//   cold and a warm list. A flat walk over the W*W lanes, an integer
//   division a lane, was slower than either. One lane per thread: a chunk of lanes per warp
//   cut the rows in flight in fused_round's fixed point (PERF.md).
// - The two-hop colors are reached net by net through the (N + G + 1, W)
//   extended adjacency, so the assignment never reads the (P, N, W*W)
//   two_hop_cidx table the collision test uses. The mask lives in a
//   register and the pick is coloring.cuh's, shared with vb_bit.cu.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "coloring.cuh"

namespace {

constexpr int kThreads = 256;

// The dense body: the neighbours two at a time, each neighbour's row of the
// extended adjacency read two entries at a time (8-byte loads; w even and
// the array 8-byte aligned), so few load instructions issue per entry.
__device__ __forceinline__ uint32_t mask_pairs(const int32_t* lanes, int w, const int32_t* x,
                                               const int32_t* t, int32_t b, bool one_hop) {
  uint32_t mask = 0u;
  for (int k = 0; k < w; k += 2) {
    const int32_t u0 = lanes[k], u1 = lanes[k + 1];
    if (one_hop) mask |= coloring::window_bit(t[u0], b) | coloring::window_bit(t[u1], b);
    const int2* n0 = reinterpret_cast<const int2*>(x + static_cast<int64_t>(u0) * w);
    const int2* n1 = reinterpret_cast<const int2*>(x + static_cast<int64_t>(u1) * w);
    for (int j = 0; j < w / 2; ++j) {
      const int2 v0 = n0[j], v1 = n1[j];
      mask |= coloring::window_bit(t[v0.x], b) | coloring::window_bit(t[v0.y], b) |
              coloring::window_bit(t[v1.x], b) | coloring::window_bit(t[v1.y], b);
    }
  }
  return mask;
}

// The sparse body (and the dense one where pairs do not fit): kRows
// neighbours at a time, kCols entries of each one's extended-adjacency row
// read together, then their kRows * kCols table entries gathered together,
// so many loads are in flight per row.
template <int kRows, int kCols>
__device__ __forceinline__ uint32_t mask_batched(const int32_t* lanes, int w, const int32_t* x,
                                                 const int32_t* t, int32_t b, bool one_hop) {
  uint32_t mask = 0u;
  for (int k0 = 0; k0 < w; k0 += kRows) {
    int32_t u[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) u[r] = k0 + r < w ? lanes[k0 + r] : -1;
    if (one_hop) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) mask |= coloring::window_bit(u[r] >= 0 ? t[u[r]] : 0, b);
    }
    for (int j0 = 0; j0 < w; j0 += kCols) {
      int32_t v[kRows][kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          v[r][c] = u[r] >= 0 && j0 + c < w ? x[static_cast<int64_t>(u[r]) * w + j0 + c] : -1;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          mask |= coloring::window_bit(v[r][c] >= 0 ? t[v[r][c]] : 0, b);
    }
  }
  return mask;
}

// kPairs: the dense body (mask_pairs), else the batched one.
template <bool kPairs>
__global__ void __launch_bounds__(kThreads) d2_assign_kernel(
    const int32_t* __restrict__ adj, const int32_t* __restrict__ ext,
    const int32_t* __restrict__ tab, int64_t tab_ps,
    const int32_t* __restrict__ rows, int64_t n_list,
    int32_t* __restrict__ newc, int32_t* __restrict__ base,
    int n, int n_tab, int w, bool partial_d2) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_list) return;
  const int32_t e = rows[i];
  const int64_t p = e / n;
  const int32_t b = base[e];
  const int32_t* lanes = adj + static_cast<int64_t>(e) * w;
  const int32_t* t = tab + p * tab_ps;
  const int32_t* x = ext + p * n_tab * static_cast<int64_t>(w);
  const uint32_t mask = kPairs ? mask_pairs(lanes, w, x, t, b, !partial_d2)
                               : mask_batched<3, 8>(lanes, w, x, t, b, !partial_d2);
  int32_t color, next_base;
  coloring::pick_color(mask, b, color, next_base);
  newc[e] = color;
  base[e] = next_base;
}

}  // namespace

// rows holds n_list entries p * N + r (each at most once); the body is
// picked by the list's density. The table may be
// strided over the part axis (tab_ps) with a contiguous row axis; adj is a
// contiguous (P, N, W) array, ext a contiguous (P, n_tab, W) array, newc and
// base contiguous (P, N) arrays updated at the listed rows only. P * N must
// fit in an int32 and every index lie in [0, n_tab). Returns 0 without a
// launch for an empty list, else cudaGetLastError() after the launch.
extern "C" int d2_assign_list_launch(const void* adj, const void* ext,
                                     const void* tab, long long tab_ps,
                                     const void* rows, long long n_list,
                                     void* newc, void* base,
                                     int n_parts, int n, int n_tab, int w,
                                     int partial_d2, void* stream) {
  if (static_cast<int64_t>(n_parts) * n > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_list == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n_list + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pairs = 4 * n_list >= static_cast<int64_t>(n_parts) * n && w % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(ext) % 8 == 0;
  const auto* a = static_cast<const int32_t*>(adj);
  const auto* x = static_cast<const int32_t*>(ext);
  const auto* t = static_cast<const int32_t*>(tab);
  const auto* r = static_cast<const int32_t*>(rows);
  auto* c = static_cast<int32_t*>(newc);
  auto* b = static_cast<int32_t*>(base);
  const bool pd = partial_d2 != 0;
  if (pairs)
    d2_assign_kernel<true><<<blocks, kThreads, 0, s>>>(a, x, t, tab_ps, r, n_list, c, b, n, n_tab, w, pd);
  else
    d2_assign_kernel<false><<<blocks, kThreads, 0, s>>>(a, x, t, tab_ps, r, n_list, c, b, n, n_tab, w, pd);
  return static_cast<int>(cudaGetLastError());
}
