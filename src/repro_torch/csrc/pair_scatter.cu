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
// direct indexed store. What bounds it on the H100: memory. The table is
// read and written once, every slot is read (pads may sit anywhere, so each
// one has to be looked at) and a real pair's value is read and stored once.
//
// Design: one launch per call. A thread-block cluster of up to 8 blocks
// covers one table row (one block covers several rows where S is small):
// 1. each block copies its share of the row, a run of about S / 8 words,
//    from table to out with 16-byte loads and stores; a run's ragged ends,
//    and a table row whose alignment differs from out's (a table_ps that
//    is no multiple of 4, or an offset view), take 4-byte accesses;
// 2. a cluster barrier, barrier.cluster.arrive.release then
//    barrier.cluster.wait.acquire, in every thread. Each thread's copy
//    stores precede its release and each thread's scatter stores follow
//    its acquire, so every copy store of the cluster happens before every
//    scatter store of the cluster, and the value of a pair is the last
//    store to its entry. A pair may land on any block's share of its row,
//    so a block barrier would not do; rows of different clusters share no
//    entry, so nothing wider is needed;
// 3. each block applies its share of the row's pairs, a run of about C / 8,
//    reading four slots with one 16-byte load and the four values with
//    another only where one of the slots is real. The row comes from the
//    cluster's index, so no thread divides.
// One cooperative launch with a grid sync between the copy and the scatter,
// as fused_round.cu orders its phases, measured no faster on the H100
// (PERF.md), so only the cluster body is kept.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;             // the portable cluster size
constexpr int kBlockWords = 4096;          // words a block copies, at least, before
                                           // a row takes a second block

struct Args {
  const int32_t* table;      // (R, S), row stride table_ps
  const int32_t* slots;      // (R, C) contiguous
  const int32_t* values;     // (R, C) contiguous
  int32_t* out;              // (R, S) contiguous
  int64_t table_ps, rows;
  int s, c;
  int cluster;               // blocks that share one group of rows
  int rows_per_group;        // > 1 only where cluster == 1
  int64_t units;             // groups x cluster: the blocks of the launch
};

__device__ __forceinline__ int64_t lmin(int64_t x, int64_t y) { return x < y ? x : y; }

__device__ __forceinline__ uint32_t phase(const void* p) {
  return static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p) >> 2) & 3u;
}

// The run [lo, lo + n) of share `rank` of `parts` over n_all words; shares
// are whole multiples of 4 words, so a 16-byte aligned row keeps its
// alignment at the start of every share.
__device__ __forceinline__ void share(int64_t n_all, int rank, int parts, int64_t& lo,
                                      int64_t& n) {
  const int64_t len = ((n_all + parts - 1) / parts + 3) & ~int64_t{3};
  lo = lmin(n_all, rank * len);
  n = lmin(n_all - lo, len);
}

// dst[0, n) = src[0, n) by thread t of nt: 16-byte accesses over the
// middle where dst and src share their alignment, 4-byte ones elsewhere.
__device__ __forceinline__ void copy_run(int32_t* __restrict__ dst,
                                         const int32_t* __restrict__ src, int64_t n, int t,
                                         int nt) {
  const uint32_t mis = phase(dst);
  if (mis != phase(src)) {
    for (int64_t i = t; i < n; i += nt) dst[i] = __ldcs(src + i);
    return;
  }
  const int64_t head = lmin((4 - mis) & 3u, n);
  const int64_t nv = (n - head) >> 2;
  const int64_t tail = head + 4 * nv;
  for (int64_t i = t; i < head + (n - tail); i += nt) {      // at most 6 words
    const int64_t k = i < head ? i : tail + (i - head);
    dst[k] = __ldcs(src + k);
  }
  int4* d = reinterpret_cast<int4*>(dst + head);
  const int4* s = reinterpret_cast<const int4*>(src + head);
  int64_t v = t;
  for (; v + 3 * nt < nv; v += 4 * nt) {        // four loads in flight
    const int4 x0 = __ldcs(s + v), x1 = __ldcs(s + v + nt);
    const int4 x2 = __ldcs(s + v + 2 * nt), x3 = __ldcs(s + v + 3 * nt);
    d[v] = x0;
    d[v + nt] = x1;
    d[v + 2 * nt] = x2;
    d[v + 3 * nt] = x3;
  }
  for (; v < nv; v += nt) d[v] = __ldcs(s + v);
}

__device__ __forceinline__ void put(int32_t* row, uint32_t s, int32_t slot, int32_t value) {
  if (static_cast<uint32_t>(slot) < s) row[slot] = value;
}

// Pair k, read with 4-byte loads: its value only where its slot is real.
__device__ __forceinline__ void put1(int32_t* row, uint32_t s, const int32_t* slots,
                                     const int32_t* values, int64_t k) {
  const int32_t slot = __ldcs(slots + k);
  if (static_cast<uint32_t>(slot) < s) row[slot] = __ldg(values + k);
}

// Four pairs, their slots already loaded: the values are read only where
// one of the slots is real.
__device__ __forceinline__ void put4(int32_t* row, uint32_t s, const int4 sl, const int4* val) {
  const bool any = static_cast<uint32_t>(sl.x) < s || static_cast<uint32_t>(sl.y) < s ||
                   static_cast<uint32_t>(sl.z) < s || static_cast<uint32_t>(sl.w) < s;
  if (!any) return;
  const int4 v = __ldg(val);
  put(row, s, sl.x, v.x);
  put(row, s, sl.y, v.y);
  put(row, s, sl.z, v.z);
  put(row, s, sl.w, v.w);
}

// row[slots[i]] = values[i] for i in [0, n) where 0 <= slots[i] < s, by
// thread t of nt: 16-byte accesses over the middle where slots and values
// share their alignment, 4-byte ones elsewhere.
__device__ __forceinline__ void scatter_run(int32_t* row, const int32_t* __restrict__ slots,
                                            const int32_t* __restrict__ values, int64_t n,
                                            int s, int t, int nt) {
  const uint32_t us = static_cast<uint32_t>(s);
  const uint32_t mis = phase(slots);
  if (mis != phase(values)) {
    for (int64_t i = t; i < n; i += nt) put1(row, us, slots, values, i);
    return;
  }
  const int64_t head = lmin((4 - mis) & 3u, n);
  const int64_t nv = (n - head) >> 2;
  const int64_t tail = head + 4 * nv;
  for (int64_t i = t; i < head + (n - tail); i += nt)
    put1(row, us, slots, values, i < head ? i : tail + (i - head));
  const int4* sl = reinterpret_cast<const int4*>(slots + head);
  const int4* va = reinterpret_cast<const int4*>(values + head);
  int64_t v = t;
  for (; v + 3 * nt < nv; v += 4 * nt) {        // four loads in flight
    const int4 s0 = __ldcs(sl + v), s1 = __ldcs(sl + v + nt);
    const int4 s2 = __ldcs(sl + v + 2 * nt), s3 = __ldcs(sl + v + 3 * nt);
    put4(row, us, s0, va + v);
    put4(row, us, s1, va + v + nt);
    put4(row, us, s2, va + v + 2 * nt);
    put4(row, us, s3, va + v + 3 * nt);
  }
  for (; v < nv; v += nt) put4(row, us, __ldcs(sl + v), va + v);
}

// One unit's copy (scatter = false) or scatter: share `rank` of every row
// of group `group`. A group of one row takes all the block's threads; the
// rows of a larger group go to the block's warps in turn.
__device__ __forceinline__ void unit(const Args& a, int64_t group, int rank, bool scatter) {
  const int64_t r0 = group * a.rows_per_group;
  const int64_t r1 = lmin(a.rows, r0 + a.rows_per_group);
  const bool one = a.rows_per_group == 1;
  const int t = one ? threadIdx.x : threadIdx.x & 31, nt = one ? kThreads : 32;
  int64_t lo, n;
  share(scatter ? a.c : a.s, rank, a.cluster, lo, n);
  for (int64_t r = r0 + (one ? 0 : threadIdx.x >> 5); r < r1; r += one ? 1 : kWarps) {
    if (scatter)
      scatter_run(a.out + r * a.s, a.slots + r * a.c + lo, a.values + r * a.c + lo, n, a.s, t,
                  nt);
    else
      copy_run(a.out + r * a.s + lo, a.table + r * a.table_ps + lo, n, t, nt);
  }
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// A cluster of a.cluster blocks per group of rows; block `rank` of the
// cluster takes share `rank`.
__global__ void __launch_bounds__(kThreads) pair_scatter_cluster_kernel(const Args a) {
  uint32_t group, rank;
  asm("mov.u32 %0, %%clusterid.x;\n" : "=r"(group));
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  unit(a, group, static_cast<int>(rank), false);
  cluster_barrier();
  unit(a, group, static_cast<int>(rank), true);
}

int launch(const Args& a, cudaStream_t st) {
  const int64_t groups = a.units / a.cluster;
  if (groups > INT32_MAX / kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.units));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, pair_scatter_cluster_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table (R, S) with row stride table_ps (elements, >= S), slots and values
// (R, C) contiguous, out (R, S) contiguous and distinct from table. With no
// pairs (C = 0) the table is copied into out on `stream` and no kernel runs.
// Returns the CUDA error of the copy or the launch, else cudaGetLastError()
// after the launch.
extern "C" int pair_scatter_launch(const void* table, long long table_ps, const void* slots,
                                   const void* values, void* out, long long rows, int s, int c,
                                   void* stream) {
  if (rows == 0 || s == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c == 0) {
    const size_t width = static_cast<size_t>(s) * sizeof(int32_t);
    return static_cast<int>(cudaMemcpy2DAsync(
        out, width, table, static_cast<size_t>(table_ps) * sizeof(int32_t), width,
        static_cast<size_t>(rows), cudaMemcpyDeviceToDevice, st));
  }
  Args a;
  a.table = static_cast<const int32_t*>(table);
  a.slots = static_cast<const int32_t*>(slots);
  a.values = static_cast<const int32_t*>(values);
  a.out = static_cast<int32_t*>(out);
  a.table_ps = table_ps;
  a.rows = rows;
  a.s = s;
  a.c = c;
  // A block for every kBlockWords of a row, up to a cluster of 8; where one
  // block is enough, as many rows as make up kBlockWords.
  const int widest = std::max(s, c);
  a.cluster = std::min(kMaxCluster, std::max(1, (widest + kBlockWords - 1) / kBlockWords));
  a.rows_per_group = a.cluster > 1 ? 1 : std::max(1, kBlockWords / widest);
  a.units = (rows + a.rows_per_group - 1) / a.rows_per_group * a.cluster;
  return launch(a, st);
}
