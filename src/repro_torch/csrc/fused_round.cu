// One whole inner round of the coloring loop in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_round.py::_make_kernel
// (wrapper fused_round), with its optional (slot, color) pair input. Same
// function, for every part p of the stacked part axis at once, bit for bit
// the decomposed round pair_scatter -> _detect_part -> zero the losers ->
// _recolor_part of the reference backend
// (repro_torch/kernels/fused_round.py::fused_round_ref):
//
//   0. with pairs: ghost[p, pair_slots[p, j]] = pair_colors[p, j] where
//      0 <= pair_slots[p, j] < G (anything else is padding and is dropped);
//   1. detect: the Algorithm-4 owned-vs-ghost sweep of conflict.cu over the
//      one-hop block (not for pd2), then over the two-hop block (d2, pd2).
//      lose_v = lost on some lane of either sweep, and is_boundary;
//      lose_ghost[p, u - N] = some lane's ghost u lost; count[p] = the
//      conflicting lanes of both sweeps (a pair seen twice counts twice);
//   2. zero the losers in the color table;
//   3. recolor the losers (active = lose_v) to each part's fixed point, at
//      most max_iters iterations shared by all running parts: (a) every
//      active uncolored row picks a color from the iteration-start table
//      (window bits of its one-hop colors unless pd2, and of its two-hop
//      colors for d2, pd2); (b) every active row loses when a neighbor of
//      the same blocks holds its new color and wins Algorithm 4; a loser
//      goes back to 0. A part runs while it has an active uncolored row.
//
// What bounds it on the H100: memory. The detection sweep reads every
// lane of the adjacency blocks (the W*W-wide two-hop block dominates for
// d2); each fixed-point iteration then touches only the active rows, the
// lanes of those rows and the table entries they name, plus one byte of
// lose_v per row to find them. The grid syncs, two per iteration, add a
// fixed cost per iteration.
//
// Design: one cooperative launch sized to the blocks that fit on the card
// at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs); blocks
// stride over tiles of 256 rows of one part, so a warp never spans two
// parts and every thread keeps the same rows in every phase. Phases end in
// cooperative_groups grid syncs. The working table tab (P, N + G + 1)
// holds owned colors, ghosts and a zero pad. Without pairs, detection
// reads the ghost input and the one sync before the fixed point stays;
// with pairs (a template flag), the ghost segment is built, a grid sync
// orders it before the pair stores (a pair may land on an entry another
// block copies), one thread per pair stores its color, and after a second
// sync detection reads the ghosts from the table. Step (a) writes new colors
// and window bases into newc and base; step (b) reads owned neighbors from
// newc and ghost and pad lanes from tab, which the loop never writes, and
// writes lose ? 0 : newc into tab's owned segment, so no phase reads what
// it writes. A row that lost is uncolored in the next (a), which rewrites
// its newc; every other row keeps newc == tab. Remaining rows are counted
// per part into one of two counters chosen by the iteration's parity: one
// block zeroes the next counter in (a), rows add to it in (b), and every
// thread reads the current one after a sync, so a reset never races a
// read. Buffers written inside the launch are read with __ldcg, through
// L2, so no block sees a stale L1 line after a sync. Ghost losses are
// plain stores of 1; counts are warp shuffle sums and one atomicAdd per
// warp (integer addition, so the order does not matter). The ragged tail
// is masked by the row bound; nothing is padded.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "coloring.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kD1 = 0, kD2 = 1, kPD2 = 2;

struct Args {
  const int32_t* adj;        // (P, N, W) contiguous
  const int32_t* two_hop;    // (P, N, H2) contiguous; d2 and pd2 only
  const int32_t* colors;     // (P, N), part stride colors_ps
  const int32_t* ghost;      // (P, G), part stride ghost_ps
  const int32_t* deg;        // (P, T), part stride tab_ps
  const int32_t* gid;        // (P, T), part stride tab_ps
  const uint8_t* boundary;   // (P, N), part stride boundary_ps
  const int32_t* pair_slots; // (P, C), part stride slots_ps; with pairs only
  const int32_t* pair_colors;// (P, C), part stride pcolors_ps
  int64_t colors_ps, ghost_ps, tab_ps, boundary_ps, slots_ps, pcolors_ps;
  int32_t* tab;              // scratch (P, T) contiguous
  int32_t* newc;             // scratch (P, N)
  int32_t* base;             // scratch (P, N)
  int32_t* remaining;        // scratch (2, P), zeroed
  int32_t* out_colors;       // (P, N)
  uint8_t* lose_v;           // (P, N)
  uint8_t* lose_ghost;       // (P, G), zeroed
  int32_t* count;            // (P,), zeroed
  int n_parts, n, g, w, h2, c, max_iters;
  bool recolor_degrees;
};

__device__ __forceinline__ int warp_sum(int x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xFFFFFFFFu, x, off);
  return x;
}

// Adds x over the warp to *dst, with one atomicAdd per warp that found some.
__device__ __forceinline__ void warp_add(int32_t* dst, int x) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0 && x != 0) atomicAdd(dst, x);
}

// The row's own degree, gid and hash, read at its first colliding lane.
struct Own {
  bool have = false;
  int32_t dv = 0, gv = 0;
  uint32_t hv = 0u;
};

// Algorithm-4 sweep of one owned row with color cv > 0 over one adjacency
// block (the body of conflict.cu): returns the conflicting lanes, or-s the
// row's loss into v_any and stores the ghost-side losses. Ghost colors come
// from the input, or with pairs from the table's patched ghost segment.
template <bool kPairs>
__device__ __forceinline__ int detect_row(const Args& a, const int32_t* lanes, int k_lanes,
                                          int64_t p, int r, int32_t cv, Own& own,
                                          bool& v_any) {
  const int32_t* ghost =
      kPairs ? a.tab + p * (a.n + a.g + 1) + a.n : a.ghost + p * a.ghost_ps;
  const int32_t* deg = a.deg + p * a.tab_ps;
  const int32_t* gid = a.gid + p * a.tab_ps;
  int found = 0;
  for (int k = 0; k < k_lanes; ++k) {
    const int32_t u = lanes[k];
    if (u < a.n || u >= a.n + a.g) continue;           // not a ghost lane
    if ((kPairs ? __ldcg(ghost + (u - a.n)) : ghost[u - a.n]) != cv) continue;
    if (!own.have) {
      own.gv = gid[r];
      if (a.recolor_degrees) own.dv = deg[r];
      own.hv = coloring::gid_hash(own.gv);
      own.have = true;
    }
    const int32_t gu = gid[u];
    if (gu == own.gv) continue;
    const int32_t du = a.recolor_degrees ? deg[u] : own.dv;
    const bool v_rule = coloring::v_loses(own.dv, du, own.hv, own.gv, gu);
    v_any |= v_rule;
    if (!v_rule) a.lose_ghost[p * a.g + (u - a.n)] = 1;
    ++found;
  }
  return found;
}

// OR of the window bits of the table colors a row's lanes name.
__device__ __forceinline__ uint32_t lane_mask(const int32_t* tab, const int32_t* lanes,
                                              int k_lanes, int32_t b) {
  uint32_t mask = 0u;
  for (int k = 0; k < k_lanes; ++k) mask |= coloring::window_bit(__ldcg(tab + lanes[k]), b);
  return mask;
}

// True where the row with new color nc loses a speculative collision to a
// lane of one block: owned lanes read newc, ghost and pad lanes the table.
__device__ __forceinline__ bool collides(const Args& a, const int32_t* lanes, int k_lanes,
                                         int64_t p, int32_t nc, int32_t dv, int32_t gv,
                                         uint32_t hv) {
  const int32_t* tab = a.tab + p * (a.n + a.g + 1);
  const int32_t* newc = a.newc + p * a.n;
  const int32_t* deg = a.deg + p * a.tab_ps;
  const int32_t* gid = a.gid + p * a.tab_ps;
  for (int k = 0; k < k_lanes; ++k) {
    const int32_t u = lanes[k];
    const int32_t cu = u < a.n ? __ldcg(newc + u) : __ldcg(tab + u);
    if (cu != nc) continue;
    const int32_t gu = gid[u];
    if (gu == gv) continue;
    const int32_t du = a.recolor_degrees ? deg[u] : dv;
    if (coloring::v_loses(dv, du, hv, gv, gu)) return true;
  }
  return false;
}

template <int kMode, bool kPairs>
__global__ void __launch_bounds__(kThreads) fused_round_kernel(const Args a) {
  constexpr bool kOneHop = kMode != kPD2;
  constexpr bool kTwoHop = kMode != kD1;
  cg::grid_group grid = cg::this_grid();
  const int tiles = (a.n + kThreads - 1) / kThreads;
  const int64_t n_tiles = static_cast<int64_t>(a.n_parts) * tiles;
  const int64_t n_tab = a.n + a.g + 1;

  // -- 1. ghost segment and pad of the table; detect; zero the losers ------
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < a.n_parts * static_cast<int64_t>(a.g + 1); i += stride) {
    const int64_t p = i / (a.g + 1);
    const int j = static_cast<int>(i - p * (a.g + 1));
    a.tab[p * n_tab + a.n + j] = j < a.g ? a.ghost[p * a.ghost_ps + j] : 0;
  }
  if (kPairs) {
    grid.sync();
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
         i < a.n_parts * static_cast<int64_t>(a.c); i += stride) {
      const int64_t p = i / a.c;
      const int j = static_cast<int>(i - p * a.c);
      const int32_t slot = a.pair_slots[p * a.slots_ps + j];
      if (static_cast<uint32_t>(slot) < static_cast<uint32_t>(a.g))
        a.tab[p * n_tab + a.n + slot] = a.pair_colors[p * a.pcolors_ps + j];
    }
    grid.sync();
  }
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t p = t / tiles;
    const int r = static_cast<int>(t - p * tiles) * kThreads + threadIdx.x;
    int found = 0, lost = 0;
    if (r < a.n) {
      const int64_t row = p * a.n + r;
      const int32_t cv = a.colors[p * a.colors_ps + r];
      bool v_any = false;
      if (cv > 0) {                          // an uncolored row collides with nothing
        Own own;
        if (kOneHop)
          found += detect_row<kPairs>(a, a.adj + row * a.w, a.w, p, r, cv, own, v_any);
        if (kTwoHop)
          found += detect_row<kPairs>(a, a.two_hop + row * a.h2, a.h2, p, r, cv, own, v_any);
      }
      lost = (v_any && a.boundary[p * a.boundary_ps + r] != 0) ? 1 : 0;
      const int32_t c = lost ? 0 : cv;
      a.lose_v[row] = static_cast<uint8_t>(lost);
      a.tab[p * n_tab + r] = c;
      a.newc[row] = c;
      a.base[row] = 1;
    }
    warp_add(a.count + p, found);
    warp_add(a.remaining + p, lost);        // active = lost, now uncolored
  }
  grid.sync();

  // -- 2. the recolor fixed point --------------------------------------------
  for (int it = 0; it < a.max_iters; ++it) {
    const int32_t* cur = a.remaining + (it & 1) * a.n_parts;
    int32_t* next = a.remaining + ((it + 1) & 1) * a.n_parts;
    bool any = false;
    for (int q = 0; q < a.n_parts; ++q) any |= __ldcg(cur + q) > 0;
    if (!any) break;                        // the same verdict in every thread
    if (blockIdx.x == 0)
      for (int q = threadIdx.x; q < a.n_parts; q += kThreads) next[q] = 0;

    // (a) assign from the iteration-start table.
    for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int64_t p = t / tiles;
      const int r = static_cast<int>(t - p * tiles) * kThreads + threadIdx.x;
      if (r >= a.n || __ldcg(cur + p) == 0) continue;
      const int64_t row = p * a.n + r;
      const int32_t* tab = a.tab + p * n_tab;
      if (a.lose_v[row] == 0 || __ldcg(tab + r) != 0) continue;
      const int32_t b = a.base[row];
      uint32_t mask = 0u;
      if (kOneHop) mask |= lane_mask(tab, a.adj + row * a.w, a.w, b);
      if (kTwoHop) mask |= lane_mask(tab, a.two_hop + row * a.h2, a.h2, b);
      int32_t color, next_base;
      coloring::pick_color(mask, b, color, next_base);
      a.newc[row] = color;
      a.base[row] = next_base;
    }
    grid.sync();

    // (b) resolve the speculative collisions into the table.
    for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int64_t p = t / tiles;
      const int r = static_cast<int>(t - p * tiles) * kThreads + threadIdx.x;
      int left = 0;
      if (r < a.n && __ldcg(cur + p) > 0) {
        const int64_t row = p * a.n + r;
        if (a.lose_v[row] != 0) {
          const int32_t nc = __ldcg(a.newc + row);
          bool lose = false;
          if (nc > 0) {
            const int32_t dv = a.deg[p * a.tab_ps + r], gv = a.gid[p * a.tab_ps + r];
            const uint32_t hv = coloring::gid_hash(gv);
            if (kTwoHop)
              lose = collides(a, a.two_hop + row * a.h2, a.h2, p, nc, dv, gv, hv);
            if (kOneHop && !lose)
              lose = collides(a, a.adj + row * a.w, a.w, p, nc, dv, gv, hv);
          }
          const int32_t c = lose ? 0 : nc;
          a.tab[p * n_tab + r] = c;
          left = c == 0 ? 1 : 0;
        }
      }
      warp_add(next + p, left);
    }
    grid.sync();
  }

  // -- 3. the owned segment is the result ------------------------------------
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t p = t / tiles;
    const int r = static_cast<int>(t - p * tiles) * kThreads + threadIdx.x;
    if (r < a.n) a.out_colors[p * a.n + r] = __ldcg(a.tab + p * n_tab + r);
  }
}

template <int kMode, bool kPairs>
int launch(const Args& args, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(&fused_round_kernel<kMode, kPairs>);
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
  if (err == cudaSuccess && per_sm == 0) err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = static_cast<int64_t>(args.n_parts) * ((args.n + kThreads - 1) / kThreads);
  int64_t blocks = static_cast<int64_t>(per_sm) * sms;
  if (blocks > tiles) blocks = tiles;
  void* params[] = {const_cast<Args*>(&args)};
  err = cudaLaunchCooperativeKernel(fn, dim3(static_cast<unsigned>(blocks)), dim3(kThreads),
                                    params, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// problem: 0 = d1, 1 = d2, 2 = pd2. Row arrays (colors, is_boundary), the
// ghosts, the pairs (pair_slots, pair_colors; (P, C), each its own stride;
// null pair_slots = no pairs) and the two tables (deg, gid; one shared
// stride) may be strided over the part axis with a contiguous row axis. adj (P, N, W) and
// two_hop (P, N, H2) are contiguous; two_hop is not read for d1. The
// scratch tab (P, N+G+1), newc and base (P, N) are contiguous and need no
// initial values; remaining (2, P), lose_ghost (P, G) and count (P,) must
// be zeroed by the caller. Returns the CUDA error of the occupancy query
// or the cooperative launch (for example cudaErrorCooperativeLaunchTooLarge),
// else cudaGetLastError() after the launch.
extern "C" int fused_round_launch(const void* adj, const void* two_hop,
                                  const void* colors, long long colors_ps,
                                  const void* ghost, long long ghost_ps,
                                  const void* deg, const void* gid, long long tab_ps,
                                  const void* boundary, long long boundary_ps,
                                  const void* pair_slots, long long slots_ps,
                                  const void* pair_colors, long long pcolors_ps,
                                  void* tab, void* newc, void* base, void* remaining,
                                  void* out_colors, void* lose_v, void* lose_ghost,
                                  void* count, int n_parts, int n, int g, int w, int h2,
                                  int c, int problem, int recolor_degrees, int max_iters,
                                  void* stream) {
  if (n_parts == 0 || n == 0) return 0;
  Args a;
  a.adj = static_cast<const int32_t*>(adj);
  a.two_hop = static_cast<const int32_t*>(two_hop);
  a.colors = static_cast<const int32_t*>(colors);
  a.ghost = static_cast<const int32_t*>(ghost);
  a.deg = static_cast<const int32_t*>(deg);
  a.gid = static_cast<const int32_t*>(gid);
  a.boundary = static_cast<const uint8_t*>(boundary);
  a.colors_ps = colors_ps;
  a.ghost_ps = ghost_ps;
  a.tab_ps = tab_ps;
  a.boundary_ps = boundary_ps;
  a.pair_slots = static_cast<const int32_t*>(pair_slots);
  a.pair_colors = static_cast<const int32_t*>(pair_colors);
  a.slots_ps = slots_ps;
  a.pcolors_ps = pcolors_ps;
  a.tab = static_cast<int32_t*>(tab);
  a.newc = static_cast<int32_t*>(newc);
  a.base = static_cast<int32_t*>(base);
  a.remaining = static_cast<int32_t*>(remaining);
  a.out_colors = static_cast<int32_t*>(out_colors);
  a.lose_v = static_cast<uint8_t*>(lose_v);
  a.lose_ghost = static_cast<uint8_t*>(lose_ghost);
  a.count = static_cast<int32_t*>(count);
  a.n_parts = n_parts;
  a.n = n;
  a.g = g;
  a.w = w;
  a.h2 = h2;
  a.c = c;
  a.max_iters = max_iters;
  a.recolor_degrees = recolor_degrees != 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pairs = pair_slots != nullptr;
  switch (problem) {
    case kD1: return pairs ? launch<kD1, true>(a, s) : launch<kD1, false>(a, s);
    case kD2: return pairs ? launch<kD2, true>(a, s) : launch<kD2, false>(a, s);
    case kPD2: return pairs ? launch<kPD2, true>(a, s) : launch<kPD2, false>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
