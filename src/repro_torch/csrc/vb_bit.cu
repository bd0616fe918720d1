// VB_BIT windowed forbidden-bitmask color assignment for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/vb_bit.py::_vb_bit_kernel
// (wrapper vb_bit_assign). Same function, on the stacked part axis:
//
//   for each part p and row r that is active and uncolored:
//     mask  = OR over lanes k of bit (c - base) for every neighbor color
//             c = tab[p, adj[p, r, k]] with 0 < c and base <= c < base + 32
//     full mask  -> color stays 0, base += 32
//     else       -> color = base + (index of the lowest clear bit)
//   every other row keeps its color and base.
//
// What bounds it on the H100: memory. Per uncolored row it reads W int32
// adjacency entries and gathers W table entries (the table of one part is
// 4 * (N + G + 1) bytes and mostly stays in the 50 MB L2 at the main
// path's size); every row reads color, base and active and writes color
// and base. There is no arithmetic worth counting.
//
// Design: one thread per (part, row), grid (ceil(N / 256), P). The mask
// lives in a register and the lowest clear bit is __ffs(~mask) - 1, so no
// shared memory and no atomics are needed. Rows that are not active and
// uncolored skip the adjacency entirely: late in a fixed point only a few
// rows are uncolored, and the launch then moves little more than the
// 13 bytes of row I/O per row. The ragged tail of the last block is
// masked by the row bound, so no input is padded.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void vb_bit_kernel(const int32_t* __restrict__ adj,
                              const int32_t* __restrict__ colors, int64_t colors_ps,
                              const int32_t* __restrict__ base, int64_t base_ps,
                              const uint8_t* __restrict__ active, int64_t active_ps,
                              const int32_t* __restrict__ tab, int64_t tab_ps,
                              int32_t* __restrict__ out_colors,
                              int32_t* __restrict__ out_base,
                              int n, int w) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int64_t p = blockIdx.y;
  if (r >= n) return;
  const int32_t c = colors[p * colors_ps + r];
  const int32_t b = base[p * base_ps + r];
  const int64_t out = p * n + r;
  if (!(active[p * active_ps + r] != 0 && c == 0)) {
    out_colors[out] = c;
    out_base[out] = b;
    return;
  }
  const int32_t* row = adj + out * w;
  const int32_t* t = tab + p * tab_ps;
  uint32_t mask = 0u;
  for (int k = 0; k < w; ++k) {
    const int32_t nc = t[row[k]];
    const int32_t rel = nc - b;
    if (nc > 0 && rel >= 0 && rel < 32) mask |= 1u << rel;
  }
  if (mask == 0xFFFFFFFFu) {
    out_colors[out] = c;
    out_base[out] = b + 32;
  } else {
    out_colors[out] = b + (__ffs(~mask) - 1);
    out_base[out] = b;
  }
}

}  // namespace

// Row arrays (colors, base, active) and the table may be strided over the
// part axis (a slice of the color table); their row axis is contiguous.
// adj is a contiguous (P, N, W) array; outputs are contiguous (P, N).
// Returns cudaGetLastError() after the launch.
extern "C" int vb_bit_assign_launch(const void* adj,
                                    const void* colors, long long colors_ps,
                                    const void* base, long long base_ps,
                                    const void* active, long long active_ps,
                                    const void* tab, long long tab_ps,
                                    void* out_colors, void* out_base,
                                    int n_parts, int n, int w, void* stream) {
  if (n_parts == 0 || n == 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads, n_parts);
  vb_bit_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(adj),
      static_cast<const int32_t*>(colors), colors_ps,
      static_cast<const int32_t*>(base), base_ps,
      static_cast<const uint8_t*>(active), active_ps,
      static_cast<const int32_t*>(tab), tab_ps,
      static_cast<int32_t*>(out_colors), static_cast<int32_t*>(out_base),
      n, w);
  return static_cast<int>(cudaGetLastError());
}
