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
// d2) and writes each row's color and lose_v byte once; each fixed-point
// iteration touches only the active rows (about 1.5% of them on the first
// round of a d1 request), their lanes and the table entries they name.
// The grid syncs, two per iteration, add a fixed cost per iteration.
//
// Design: one cooperative launch sized to the blocks that fit on the card
// at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs); phases end
// in cooperative_groups grid syncs.
// - Detection strides over tiles of 256 rows of one part (a warp never
//   spans two parts). A tile's lanes are one contiguous run of 256 * W
//   int32 (and 256 * H2 of the two-hop block): one bulk asynchronous copy
//   (cp.async.bulk, completing on an mbarrier) stages its 16-byte-aligned
//   middle into shared memory, threads copy the few words of its ragged
//   ends, and the copy of the block's next tile is issued before this
//   tile's sweep, into the other of two buffers. Each thread then sweeps
//   its row's lanes from shared memory (a stride of W or H2 words: 2-way
//   bank conflicts at W = 6, 4-way at H2 = 36; reading the rows 16 bytes
//   at a time, which has none, measured no faster on the H100: the sweep
//   waits for device memory, not for shared memory). Blocks whose staged
//   tiles would not fit in 96 KB read their lanes from device memory.
//   Detection writes out_colors and lose_v for every row and appends each
//   losing row, p * N + r, to one compacted list (the warp's losers take
//   consecutive entries from one atomicAdd), writing newc = 0 and base = 1
//   for listed rows only.
// - The fixed point walks the list: (a) every entry of a running part
//   whose row is uncolored picks a color from out_colors (owned lanes),
//   the ghost colors and the zero pad, into newc and base; (b) every entry
//   of a running part reads owned neighbors' new colors from newc where
//   their lose_v byte is set and from out_colors elsewhere, ghosts from the
//   ghost colors, and writes lose ? 0 : newc into its out_colors entry.
//   No phase reads what it writes (out_colors changes in (b) only at listed
//   rows, which (b) reads from newc), so the result is the same in any list
//   order. A row that lost is uncolored in the next (a), which rewrites its
//   newc; every other listed row keeps newc == out_colors. A thread takes
//   one entry at a time (the grid strides over the list) and gathers its
//   row's lanes, and the table entries they name, eight at a time, so their
//   loads overlap; every lane is tested, none skipped after a collision.
// - With pairs (a template flag), the ghost colors are copied into scratch
//   after the list, a grid sync orders the copy before the pair stores (a
//   pair may land on an entry another block copies), one thread per pair
//   stores its color, and after a second sync every phase reads the
//   ghosts from the scratch; without pairs they are read from the input.
// - A part with a row left uncolored is flagged in one of two rows of
//   flags chosen by the iteration's parity (the first iteration reads the
//   losers per part that detection counted; only > 0 is ever read): one
//   block zeroes the next row in (a), one lane per warp and part stores 1
//   into it in (b), and every thread reads the current one after a sync,
//   so a reset never races a read. Buffers written inside the launch are
//   read with __ldcg, through L2, so no block sees a stale L1 line after a
//   sync. Ghost losses are plain stores of 1; counts are warp sums and one
//   atomicAdd per warp and part (integer addition, so the order does not
//   matter).
#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "coloring.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;              // threads per block; rows per detection tile
constexpr int kD1 = 0, kD2 = 1, kPD2 = 2;
constexpr int kMaxStageBytes = 96 * 1024;   // both staging buffers, at most

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
  int32_t* list;             // scratch: up to P * N entries p * N + r
  int32_t* ghost_tab;        // scratch (P, G + 1): the patched ghosts; with pairs only
  int32_t* newc;             // scratch (P, N), listed rows only
  int32_t* base;             // scratch (P, N), listed rows only
  int32_t* lost;             // (P,) zeroed: losers per part, the first iteration's flags
  int32_t* flags;            // (2, P) zeroed: the later iterations' flags
  int32_t* list_len;         // (1,) zeroed
  int32_t* out_colors;       // (P, N)
  uint8_t* lose_v;           // (P, N)
  uint8_t* lose_ghost;       // (P, G), zeroed
  int32_t* count;            // (P,), zeroed
  int n_parts, n, g, w, h2, c, max_iters;
  int stage_a, stage_h;      // words of a staging buffer per block; 0 = not staged
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

// ---- staging a tile's lanes -------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` of the barrier has completed.
// A wait of more than 4 s means an arrival or a copy was lost: the kernel
// traps (the launch fails) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  uint64_t t0, now;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t0));
  while (!mbar_try(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (now - t0 > 4000000000ull) __trap();
  }
}

// Where the words [e0, e1) of `arr` go in a 16-byte-aligned staging buffer:
// word e0 at buf + off, so that 16-byte-aligned words stay aligned; the
// aligned middle [mid0, mid1) is one bulk copy (empty when mid1 <= mid0).
struct Run {
  const int32_t* src = nullptr;
  int64_t e0 = 0, e1 = 0, mid0 = 0, mid1 = 0;
  int off = 0;
};

__device__ __forceinline__ Run plan_run(const int32_t* arr, int64_t e0, int64_t e1) {
  Run r;
  r.src = arr;
  r.e0 = e0;
  r.e1 = e1;
  const int mis0 = static_cast<int>((reinterpret_cast<uintptr_t>(arr + e0) & 15u) >> 2);
  const int mis1 = static_cast<int>((reinterpret_cast<uintptr_t>(arr + e1) & 15u) >> 2);
  r.off = mis0;
  r.mid0 = e0 + ((4 - mis0) & 3);
  r.mid1 = e1 - mis1;
  if (r.mid1 <= r.mid0) r.mid0 = r.mid1 = e1;            // too short: no bulk copy
  return r;
}

__device__ __forceinline__ uint32_t bulk_bytes(const Run& r) {
  return static_cast<uint32_t>((r.mid1 - r.mid0) * 4);
}

// Thread 0 issues the middle of a run as one bulk copy completing on bar.
__device__ __forceinline__ void bulk_copy(const Run& r, int32_t* buf, uint32_t bar) {
  const uint32_t bytes = bulk_bytes(r);
  if (bytes == 0) return;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(buf + r.off + (r.mid0 - r.e0))), "l"(r.src + r.mid0), "r"(bytes), "r"(bar)
      : "memory");
}

// Every thread: the words outside the bulk copy, with plain loads.
__device__ __forceinline__ void copy_ends(const Run& r, int32_t* buf) {
  const int head = static_cast<int>(r.mid0 - r.e0);
  const int tail = static_cast<int>(r.e1 - r.mid1);
  for (int i = threadIdx.x; i < head + tail; i += kThreads) {
    const int64_t e = i < head ? r.e0 + i : r.mid1 + (i - head);
    buf[r.off + (e - r.e0)] = r.src[e];
  }
}

// ---- the sweep and the fixed point ------------------------------------------

// The row's own degree, gid and hash, read at its first colliding lane.
struct Own {
  bool have = false;
  int32_t dv = 0, gv = 0;
  uint32_t hv = 0u;
};

// A part's ghost colors: the input, or with pairs the patched scratch.
template <bool kPairs>
__device__ __forceinline__ const int32_t* ghosts(const Args& a, int64_t p) {
  return kPairs ? a.ghost_tab + p * (a.g + 1) : a.ghost + p * a.ghost_ps;
}

template <bool kPairs>
__device__ __forceinline__ int32_t ghost_color(const int32_t* gh, int32_t j) {
  return kPairs ? __ldcg(gh + j) : gh[j];
}

// Algorithm-4 sweep of one owned row with color cv > 0 over one adjacency
// block (the body of conflict.cu): returns the conflicting lanes, or-s the
// row's loss into v_any and stores the ghost-side losses.
template <bool kPairs>
__device__ __forceinline__ int detect_row(const Args& a, const int32_t* lanes, int k_lanes,
                                          int64_t p, int r, int32_t cv, Own& own,
                                          bool& v_any) {
  const int32_t* gh = ghosts<kPairs>(a, p);
  const int32_t* deg = a.deg + p * a.tab_ps;
  const int32_t* gid = a.gid + p * a.tab_ps;
  int found = 0;
  for (int k = 0; k < k_lanes; ++k) {
    const int32_t u = lanes[k];
    if (u < a.n || u >= a.n + a.g) continue;           // not a ghost lane
    if (ghost_color<kPairs>(gh, u - a.n) != cv) continue;
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

constexpr int kBatch = 8;                 // lanes a thread gathers at once

// The iteration-start table color of lane u of part p: owned lanes from
// out_colors, ghosts, the pad (0). The owned and ghost loads are issued
// together, each in bounds, and one is kept.
template <bool kPairs>
__device__ __forceinline__ int32_t table_color(const Args& a, const int32_t* own,
                                               const int32_t* gh, int32_t u) {
  const bool owned = u < a.n, ghost = !owned && u < a.n + a.g;
  const int32_t co = owned ? __ldcg(own + u) : 0;
  const int32_t cg = ghost ? ghost_color<kPairs>(gh, u - a.n) : 0;
  return owned ? co : cg;
}

// OR of the window bits of the iteration-start table colors a row's lanes
// name, kBatch lanes (and their table entries) in flight at a time.
template <bool kPairs>
__device__ __forceinline__ uint32_t lane_mask(const Args& a, const int32_t* lanes, int k_lanes,
                                              int64_t p, int32_t b) {
  const int32_t* own = a.out_colors + p * a.n;
  const int32_t* gh = ghosts<kPairs>(a, p);
  const int32_t pad = a.n + a.g;
  uint32_t mask = 0u;
  for (int k0 = 0; k0 < k_lanes; k0 += kBatch) {
    int32_t u[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) u[j] = k0 + j < k_lanes ? lanes[k0 + j] : pad;
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      mask |= coloring::window_bit(table_color<kPairs>(a, own, gh, u[j]), b);
  }
  return mask;
}

// True where the row with new color nc loses a speculative collision to a
// lane of one block: owned lanes read newc where they are listed (lose_v)
// and out_colors elsewhere (the three loads issued together), ghost lanes
// the ghost colors; the pad (color 0) never collides. All lanes are tested,
// kBatch at a time, so their loads overlap.
template <bool kPairs>
__device__ __forceinline__ bool collides(const Args& a, const int32_t* lanes, int k_lanes,
                                         int64_t p, int32_t nc, int32_t dv, int32_t gv,
                                         uint32_t hv) {
  const int64_t row0 = p * a.n;
  const int32_t* gh = ghosts<kPairs>(a, p);
  const int32_t* deg = a.deg + p * a.tab_ps;
  const int32_t* gid = a.gid + p * a.tab_ps;
  const int32_t pad = a.n + a.g;
  bool lose = false;
  for (int k0 = 0; k0 < k_lanes; k0 += kBatch) {
    int32_t u[kBatch], cu[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) u[j] = k0 + j < k_lanes ? lanes[k0 + j] : pad;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const bool owned = u[j] < a.n, ghost = !owned && u[j] < pad;
      const uint8_t listed = owned ? __ldcg(a.lose_v + row0 + u[j]) : 0;
      const int32_t cn = owned ? __ldcg(a.newc + row0 + u[j]) : 0;
      const int32_t co = owned ? __ldcg(a.out_colors + row0 + u[j]) : 0;
      const int32_t cg = ghost ? ghost_color<kPairs>(gh, u[j] - a.n) : 0;
      cu[j] = owned ? (listed ? cn : co) : cg;       // the pad reads 0 and never collides
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (cu[j] != nc) continue;
      const int32_t gu = gid[u[j]];
      if (gu == gv) continue;
      const int32_t du = a.recolor_degrees ? deg[u[j]] : dv;
      lose |= coloring::v_loses(dv, du, hv, gv, gu);
    }
  }
  return lose;
}

template <int kMode, bool kPairs>
__global__ void __launch_bounds__(kThreads) fused_round_kernel(const Args a) {
  constexpr bool kOneHop = kMode != kPD2;
  constexpr bool kTwoHop = kMode != kD1;
  extern __shared__ int4 stage_raw[];
  __shared__ __align__(8) uint64_t stage_bar[2];
  cg::grid_group grid = cg::this_grid();
  const int tiles = (a.n + kThreads - 1) / kThreads;
  const int64_t n_tiles = static_cast<int64_t>(a.n_parts) * tiles;
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;

  // -- 0. with pairs: the patched ghost colors --------------------------------
  if (kPairs) {
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
         i < a.n_parts * static_cast<int64_t>(a.g + 1); i += stride) {
      const int64_t p = i / (a.g + 1);
      const int j = static_cast<int>(i - p * (a.g + 1));
      a.ghost_tab[i] = j < a.g ? a.ghost[p * a.ghost_ps + j] : 0;
    }
    grid.sync();
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
         i < a.n_parts * static_cast<int64_t>(a.c); i += stride) {
      const int64_t p = i / a.c;
      const int j = static_cast<int>(i - p * a.c);
      const int32_t slot = a.pair_slots[p * a.slots_ps + j];
      if (static_cast<uint32_t>(slot) < static_cast<uint32_t>(a.g))
        a.ghost_tab[p * (a.g + 1) + slot] = a.pair_colors[p * a.pcolors_ps + j];
    }
    grid.sync();
  }

  // -- 1. detect, zero the losers, list them ------------------------------------
  const bool staged = a.stage_a + a.stage_h > 0;
  int32_t* stage = reinterpret_cast<int32_t*>(stage_raw);
  const int buf_words = a.stage_a + a.stage_h;
  // The runs of tile t: its rows' one-hop and two-hop lanes.
  auto runs = [&](int64_t t, Run& ra, Run& rh) {
    const int64_t p = t / tiles;
    const int64_t r0 = p * a.n + (t - p * tiles) * kThreads;
    const int64_t r1 = p * a.n + min(static_cast<int64_t>(a.n), (t - p * tiles + 1) * kThreads);
    if (kOneHop) ra = plan_run(a.adj, r0 * a.w, r1 * a.w);
    if (kTwoHop) rh = plan_run(a.two_hop, r0 * a.h2, r1 * a.h2);
  };
  auto issue = [&](int64_t t, int buf) {
    Run ra, rh;
    runs(t, ra, rh);
    int32_t* ba = stage + buf * buf_words;
    int32_t* bh = ba + a.stage_a;
    if (threadIdx.x == 0) {
      const uint32_t bar = smem_u32(&stage_bar[buf]);
      const uint32_t bytes = (kOneHop ? bulk_bytes(ra) : 0u) + (kTwoHop ? bulk_bytes(rh) : 0u);
      // The buffer was last read by this block's threads (generic proxy).
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(bytes)
                   : "memory");
      if (kOneHop) bulk_copy(ra, ba, bar);
      if (kTwoHop) bulk_copy(rh, bh, bar);
    }
    if (kOneHop) copy_ends(ra, ba);
    if (kTwoHop) copy_ends(rh, bh);
  };
  if (staged) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < 2; ++i)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&stage_bar[i]))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (blockIdx.x < n_tiles) issue(blockIdx.x, 0);
  }
  uint32_t phases = 0u;                                  // parity of each buffer's barrier
  int buf = 0;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x, buf ^= 1) {
    const int64_t p = t / tiles;
    const int r = static_cast<int>(t - p * tiles) * kThreads + threadIdx.x;
    const int32_t* la = nullptr;
    const int32_t* lh = nullptr;
    if (staged) {
      if (t + gridDim.x < n_tiles) issue(t + gridDim.x, buf ^ 1);
      mbar_wait(smem_u32(&stage_bar[buf]), (phases >> buf) & 1u);
      phases ^= 1u << buf;
      __syncthreads();                                   // the ends are stored
      Run ra, rh;
      runs(t, ra, rh);
      // This thread's row is the tile's row threadIdx.x.
      if (kOneHop) la = stage + buf * buf_words + ra.off + threadIdx.x * a.w;
      if (kTwoHop) lh = stage + buf * buf_words + a.stage_a + rh.off + threadIdx.x * a.h2;
    } else {
      if (kOneHop) la = a.adj + (p * a.n + r) * a.w;
      if (kTwoHop) lh = a.two_hop + (p * a.n + r) * a.h2;
    }
    int found = 0;
    bool lost = false;
    if (r < a.n) {
      const int64_t row = p * a.n + r;
      const int32_t cv = a.colors[p * a.colors_ps + r];
      bool v_any = false;
      if (cv > 0) {                          // an uncolored row collides with nothing
        Own own;
        if (kOneHop) found += detect_row<kPairs>(a, la, a.w, p, r, cv, own, v_any);
        if (kTwoHop) found += detect_row<kPairs>(a, lh, a.h2, p, r, cv, own, v_any);
      }
      lost = v_any && a.boundary[p * a.boundary_ps + r] != 0;
      a.lose_v[row] = static_cast<uint8_t>(lost);
      a.out_colors[row] = lost ? 0 : cv;
      if (lost) {
        a.newc[row] = 0;
        a.base[row] = 1;
      }
    }
    warp_add(a.count + p, found);
    // The warp's losers (all of part p) take consecutive list entries.
    const unsigned losers = __ballot_sync(0xFFFFFFFFu, lost);
    if (losers != 0u) {
      int at = 0;
      if (lane == 0) {
        at = atomicAdd(a.list_len, __popc(losers));
        atomicAdd(a.lost + p, __popc(losers));
      }
      at = __shfl_sync(0xFFFFFFFFu, at, 0);
      if (lost)
        a.list[at + __popc(losers & ((1u << lane) - 1u))] = static_cast<int32_t>(p * a.n + r);
    }
    if (staged) __syncthreads();                         // the buffer is read
  }
  grid.sync();

  // -- 2. the recolor fixed point over the list ---------------------------------
  const int64_t len = __ldcg(a.list_len);
  const int64_t warp0 = static_cast<int64_t>(blockIdx.x) * kThreads + (threadIdx.x & ~31);
  for (int it = 0; it < a.max_iters; ++it) {
    const int32_t* cur = it == 0 ? a.lost : a.flags + ((it - 1) & 1) * a.n_parts;
    int32_t* next = a.flags + (it & 1) * a.n_parts;
    bool any = false;
    for (int q = 0; q < a.n_parts; ++q) any |= __ldcg(cur + q) > 0;
    if (!any) break;                        // the same verdict in every thread
    if (blockIdx.x == 0)
      for (int q = threadIdx.x; q < a.n_parts; q += kThreads) next[q] = 0;

    // (a) assign from the iteration-start table.
    for (int64_t e = warp0 + lane; e - lane < len; e += stride) {
      if (e >= len) continue;
      const int64_t row = __ldcg(a.list + e);
      const int64_t p = row / a.n;
      if (__ldcg(cur + p) == 0 || __ldcg(a.out_colors + row) != 0) continue;
      const int32_t b = __ldcg(a.base + row);
      uint32_t mask = 0u;
      if (kOneHop) mask |= lane_mask<kPairs>(a, a.adj + row * a.w, a.w, p, b);
      if (kTwoHop) mask |= lane_mask<kPairs>(a, a.two_hop + row * a.h2, a.h2, p, b);
      int32_t color, next_base;
      coloring::pick_color(mask, b, color, next_base);
      a.newc[row] = color;
      a.base[row] = next_base;
    }
    grid.sync();

    // (b) resolve the speculative collisions into out_colors; a part with
    // a row left uncolored is flagged to run again.
    for (int64_t e = warp0 + lane; e - lane < len; e += stride) {
      int key = -1;                          // the part of a row left uncolored
      if (e < len) {
        const int64_t row = __ldcg(a.list + e);
        const int64_t p = row / a.n;
        if (__ldcg(cur + p) > 0) {
          const int r = static_cast<int>(row - p * a.n);
          const int32_t nc = __ldcg(a.newc + row);
          bool lose = false;
          if (nc > 0) {
            const int32_t dv = a.deg[p * a.tab_ps + r], gv = a.gid[p * a.tab_ps + r];
            const uint32_t hv = coloring::gid_hash(gv);
            if (kTwoHop)
              lose = collides<kPairs>(a, a.two_hop + row * a.h2, a.h2, p, nc, dv, gv, hv);
            if (kOneHop && !lose)
              lose = collides<kPairs>(a, a.adj + row * a.w, a.w, p, nc, dv, gv, hv);
          }
          const int32_t c = lose ? 0 : nc;
          a.out_colors[row] = c;
          if (c == 0) key = static_cast<int>(p);
        }
      }
      const unsigned same = __match_any_sync(0xFFFFFFFFu, key);
      if (key >= 0 && lane == __ffs(same) - 1) next[key] = 1;
    }
    grid.sync();
  }
}

template <int kMode, bool kPairs>
int launch(Args args, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(&fused_round_kernel<kMode, kPairs>);
  // Staging buffers: 256 rows of each swept block and 4 words of slack for
  // the alignment offset, in 16-byte units, twice.
  auto words = [](int lanes) { return (kThreads * lanes + 4 + 3) / 4 * 4; };
  args.stage_a = kMode != kPD2 ? words(args.w) : 0;
  args.stage_h = kMode != kD1 ? words(args.h2) : 0;
  int smem = 2 * (args.stage_a + args.stage_h) * static_cast<int>(sizeof(int32_t));
  if (smem > kMaxStageBytes) {
    args.stage_a = args.stage_h = 0;
    smem = 0;
  }
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  if (err == cudaSuccess && per_sm == 0) err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = static_cast<int64_t>(args.n_parts) * ((args.n + kThreads - 1) / kThreads);
  int64_t blocks = static_cast<int64_t>(per_sm) * sms;
  if (blocks > tiles) blocks = tiles;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(fn, dim3(static_cast<unsigned>(blocks)), dim3(kThreads),
                                    params, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// problem: 0 = d1, 1 = d2, 2 = pd2. Row arrays (colors, is_boundary), the
// ghosts, the pairs (pair_slots, pair_colors; (P, C), each its own stride;
// null pair_slots = no pairs) and the two tables (deg, gid; one shared
// stride) may be strided over the part axis with a contiguous row axis.
// adj (P, N, W) and two_hop (P, N, H2) are contiguous; two_hop is not read
// for d1. The scratch tab (P, N+G+1) (the list of losing rows, then with
// pairs the patched ghosts), newc and base (P, N) are contiguous and need
// no initial values; remaining (3P + 1: the losers per part, two rows of
// per-part flags, the list's length), lose_ghost (P, G) and count (P,) must be
// zeroed by the caller. P * N must fit in an int32. Returns the CUDA error
// of the occupancy query or the cooperative launch (for example
// cudaErrorCooperativeLaunchTooLarge), else cudaGetLastError() after the
// launch.
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
  if (static_cast<int64_t>(n_parts) * n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
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
  a.list = static_cast<int32_t*>(tab);
  a.ghost_tab = a.list + static_cast<int64_t>(n_parts) * n;
  a.newc = static_cast<int32_t*>(newc);
  a.base = static_cast<int32_t*>(base);
  a.lost = static_cast<int32_t*>(remaining);
  a.flags = a.lost + n_parts;
  a.list_len = a.flags + 2 * n_parts;
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
