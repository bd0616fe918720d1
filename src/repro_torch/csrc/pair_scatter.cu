// Batched (slot-id, value) pair scatter into slot tables, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/scatter.py::_pair_scatter_kernel
// (wrapper pair_scatter). Same function, for every row r of a batch at once:
//
//   out[r, :] = table[r, :];  out[r, slots[r, j]] = values[r, j] where
//   0 <= slots[r, j] < S (anything else is padding and is dropped).
//
// The real slots of one row are unique, so no two threads store to one
// entry and the result does not depend on the order of the stores.
//
// The TPU kernel turns the scatter into a gather, comparing every table
// position of a tile with the whole pair list ((TILE, C) compares), because
// a TPU has no fast scatter. Hopper stores to any address, so this is a
// direct indexed store: one thread per pair. What bounds it on the H100:
// memory. The table is copied (read and written once, a device-to-device
// copy on the caller's stream before the kernel), then each thread reads
// its slot and, for a real pair, its value and stores one word. The copy
// must be finished before any store, which is why copy and scatter are two
// operations on one stream and not one launch across blocks.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pair_scatter_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ slots,
                    const int32_t* __restrict__ values, int64_t n_pairs, int s, int c) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n_pairs;
       i += stride) {
    const int32_t slot = slots[i];
    if (static_cast<uint32_t>(slot) >= static_cast<uint32_t>(s)) continue;   // pad
    const int64_t row = i / c;
    out[row * s + slot] = values[i];
  }
}

}  // namespace

// table (R, S) with row stride table_ps (elements, >= S), slots and values
// (R, C) contiguous, out (R, S) contiguous and distinct from table. Copies
// table into out, then scatters, both on `stream`. Returns the CUDA error
// of the copy or the launch, else cudaGetLastError() after the launch.
extern "C" int pair_scatter_launch(const void* table, long long table_ps, const void* slots,
                                   const void* values, void* out, long long rows, int s,
                                   int c, void* stream) {
  if (rows == 0 || s == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t width = static_cast<size_t>(s) * sizeof(int32_t);
  cudaError_t err = cudaMemcpy2DAsync(out, width, table,
                                      static_cast<size_t>(table_ps) * sizeof(int32_t), width,
                                      static_cast<size_t>(rows), cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_pairs = static_cast<int64_t>(rows) * c;
  if (n_pairs == 0) return 0;
  int64_t blocks = (n_pairs + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;     // the loop strides over the rest
  pair_scatter_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<int32_t*>(out), static_cast<const int32_t*>(slots),
      static_cast<const int32_t*>(values), n_pairs, s, c);
  return static_cast<int>(cudaGetLastError());
}
