// The Algorithm-4 speculative-collision test of the local fixed points, for
// Hopper (sm_90a).
//
// No TPU kernel: repro runs this test in jnp between its assignment launches
// (src/repro/kernels/ops.py::local_color_d1_pallas, :72-80, and
// local_color_d2_pallas, :146-160); the port's plain version is
// repro_torch/core/local.py::collision_losers. One C entry, two kinds of
// launch, on the stacked part axis (P parts of R rows; the table of each
// part has T >= R entries, rows first):
//
//   listing (the first launch of a fixed point): for every
//     row e = p * R + r that is active, append e to the list of active rows
//     `rows_out`; if its table color is 0, also append it to the rows to
//     color `todo` and count it for part p. Optionally newc[e] = tab[p, r]
//     for every row and base[e] = 1 for every active row. Nothing is tested.
//   testing (every later launch, one per iteration): for every entry e of
//     `rows` whose part is running (cur[p] > 0), with new color
//     nc = newc[e]:
//       lose = nc > 0 and some lane u of the lane blocks (lanes_a, then
//              lanes_b) holds nc, has another gid and wins Algorithm 4, the
//              lane's color being newc[p, u] for u < R (rows) and tab[p, u]
//              for u >= R (ghosts, pad);
//       tab[p, r] = lose ? 0 : nc;  lose byte of the entry = lose;
//       a row left at 0 is appended to `todo` and counted for part p.
//     Entries of stopped parts are left alone (lose byte 0). This equals
//     collision_losers(newc, tab with newc in its rows, lanes, ...)[p, r]
//     followed by where(active & lose, 0, newc) at the entry's row.
//
// What bounds it on the H100: memory. A tested row reads its entry, its new
// color and its lanes (36 + 6 int32 at d2 on a hex mesh), gathers the color
// each lane names, and reads degree and gid only on lanes whose colors
// collide; it writes its color, a lose byte and, if uncolored, one list
// entry. There is no arithmetic worth counting.
//
// Design: a listing launch takes one thread per row, a block walking up to
// 16 consecutive tiles of 256 rows (fewer where that would leave the card
// short of blocks). A testing launch takes one thread per listed row for
// its first 8 lanes and a group of 8 threads per row for the rest of the
// lanes of the rows still undecided.
// - The result does not depend on the order of the list: a testing launch
//   reads rows' colors from newc only and writes the table only at rows, so
//   no thread reads what another writes (the table's ghost and pad entries,
//   which it does read, are never written). This holds on asymmetric lanes,
//   where an old colored row can lose to a row colored in this iteration.
// - First batch, a thread per row: the row's first 8 lanes are read with
//   16- or 8-byte loads as soon as its entry is (before its part's count
//   and new color), their colors gathered together, then at once the gid
//   (and degree) of every lane whose color collides and the row's own. On a
//   mesh whose rows are numbered along its grid, lane j of consecutive rows
//   names entries a fixed distance apart, so a warp's gathers are coalesced
//   lane by lane. Most rows of a cold iteration (every row with color 1)
//   lose there.
// - The rest of the lanes: where at most 16 rows of the warp are still
//   undecided, groups of 8 threads take them 4 at a time, each thread 5 of
//   the row's lanes (40 a chunk: the 34 left of d2's 42 in one), the same
//   gathers and one ballot for the verdicts; the row's own gid, degree and
//   hash come from its thread by shuffle. A row that beats its first lanes
//   no longer walks the rest one dependent load after the other while its
//   warp waits. Where more rows are undecided (a warm iteration, where few
//   colors collide), each goes on alone, 8 lanes at a time. The body is
//   built twice, for 5 and for 4 blocks an SM; a list that holds at least a
//   quarter of the rows takes the first (on the H100 it measured faster on
//   cold lists, the second on warm ones).
// - A group of G threads per row for all its lanes (G = 8 up to 8 lanes,
//   16 beyond) gives coalesced lane loads, but a warp's gathers then name
//   the neighbours of 2 to 4 rows, ten times the cache lines of a thread per
//   row; on the H100 it measured slower on every list (PERF.md).
// - The testing launch appends block by block: one atomicAdd per block on
//   the list's cursor, one per part present in the block on the counts (in
//   shared memory for up to 64 parts). Appending warp by warp serialised on the
//   cursor and took most of a cold iteration's time on the H100. A listing
//   launch, which does little else, stages the entries a block appends
//   over its tiles in shared memory (in tile, warp and lane order) and
//   takes their places with one atomicAdd per list at its end.
// - The counts live in three rows of P + 2 words used in turn by the caller
//   (per part, the total, and after a listing launch the active rows): a
//   testing launch reads `cur`, adds into `next` and zeroes `spare`, the row
//   the launch after next adds into; `cur` was zeroed two launches ago.
#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "coloring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kFirst = 8;          // lanes a thread tests alone first
constexpr int kGroup = 8;          // threads a group gives a row still undecided
constexpr int kGroupLanes = 5;     // lanes a group thread reads per chunk
constexpr int kCoop = 16;          // undecided rows a warp gives to groups, at most
constexpr unsigned kGroupBits = (1u << kGroup) - 1u;  // a group's bits of a warp ballot

struct Args {
  const int32_t* lanes_a;          // (P, R, wa) contiguous
  const int32_t* lanes_b;          // (P, R, wb) contiguous, or null
  const int32_t* newc;             // (P, R) contiguous: the rows' new colors
  int32_t* tab;                    // (P, T), part stride tab_ps
  const int32_t* deg;              // (P, T), part stride dg_ps
  const int32_t* gid;
  const uint8_t* active;           // (P, R), part stride active_ps (listing)
  const int32_t* rows;             // (n_list,) entries p * R + r (testing)
  const int32_t* cur;              // (P + 2,) this iteration's counts (testing)
  int32_t* next;                   // (P + 2,) zeroed: what this launch counts
  int32_t* spare;                  // (P + 2,) zeroed here (testing)
  int32_t* rows_out;               // (P * R,) the active rows (listing)
  int32_t* todo;                   // (P * R,) the rows left to color, or null
  int32_t* newc_out;               // (P, R) or null (listing)
  int32_t* base_out;               // (P, R) or null (listing)
  uint8_t* lose;                   // (n_list,) (testing)
  int64_t tab_ps, dg_ps, active_ps, n_list;
  int wa, wb, n_parts, r_rows;
  int tiles;                       // tiles of kThreads rows a listing block walks
  bool recolor_degrees;
};

constexpr int kWarps = kThreads / 32;
constexpr int kMaxTiles = 16;                    // tiles a listing block walks, at most
constexpr int kSmemParts = 1024;                 // parts counted in shared memory

// The entries a block appends to one list, staged over its tiles.
struct Stage {
  int32_t entries[kMaxTiles * kThreads];
  int warp_at[kWarps];
  int n, at;                                     // staged entries; their place in the list
};

// Every thread of the block calls, once per tile: stages e where `take`,
// and counts it for part p (into cnt, in shared memory, or for more parts
// than kSmemParts straight into count).
__device__ __forceinline__ void stage(Stage& s, int* cnt, int32_t* count, int n_parts,
                                      bool take, int64_t p, int32_t e) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned all = __ballot_sync(0xFFFFFFFFu, take);
  if (lane == 0) s.warp_at[warp] = __popc(all);
  if (cnt != nullptr) {
    const unsigned same = __match_any_sync(0xFFFFFFFFu, take ? static_cast<int>(p) : -1);
    if (take && lane == __ffs(same) - 1)
      atomicAdd(n_parts <= kSmemParts ? cnt + p : count + p, __popc(same));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = s.n;
    for (int w = 0; w < kWarps; ++w) {
      const int c = s.warp_at[w];
      s.warp_at[w] = n;
      n += c;
    }
    s.n = n;
  }
  __syncthreads();
  if (take) s.entries[s.warp_at[warp] + __popc(all & ((1u << lane) - 1u))] = e;
  __syncthreads();                               // warp_at is rewritten by the next tile
}

// Every thread of the block calls, after its last tile: takes the staged
// entries' places at the cursor *len, writes them to `list` (if any) and
// adds the block's per-part counts into count.
__device__ __forceinline__ void flush(Stage& s, const int* cnt, int32_t* list, int32_t* len,
                                      int32_t* count, int n_parts) {
  if (threadIdx.x == 0) s.at = s.n > 0 ? atomicAdd(len, s.n) : 0;
  __syncthreads();
  if (list != nullptr)
    for (int j = threadIdx.x; j < s.n; j += kThreads) list[s.at + j] = s.entries[j];
  if (cnt != nullptr && n_parts <= kSmemParts)
    for (int q = threadIdx.x; q < n_parts; q += kThreads)
      if (cnt[q] != 0) atomicAdd(count + q, cnt[q]);
}

constexpr int kBlockParts = 64;                  // parts a testing block counts in shared memory

// Every thread of the block calls, once: appends e, where `take`, to `list`
// (if any) at the cursor *len with one atomicAdd per block, in warp and
// lane order, and adds the appended entries per part into count[p]: for up
// to kBlockParts parts in shared memory first, one atomicAdd per part
// present in the block, else one per part present in a warp.
__device__ __forceinline__ void block_append(int32_t* list, int32_t* len, int32_t* count,
                                             int n_parts, bool take, int64_t p, int32_t e) {
  __shared__ int warp_at[kWarps + 1];
  __shared__ int cnt[kBlockParts];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool local = n_parts <= kBlockParts;
  if (local)
    for (int q = threadIdx.x; q < n_parts; q += kThreads) cnt[q] = 0;
  const unsigned all = __ballot_sync(0xFFFFFFFFu, take);
  if (lane == 0) warp_at[warp] = __popc(all);
  __syncthreads();
  const unsigned same = __match_any_sync(0xFFFFFFFFu, take ? static_cast<int>(p) : -1);
  if (take && lane == __ffs(same) - 1) atomicAdd(local ? cnt + p : count + p, __popc(same));
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_at[w];
      warp_at[w] = n;
      n += c;
    }
    warp_at[kWarps] = n > 0 ? atomicAdd(len, n) : 0;
  }
  if (local)
    for (int q = threadIdx.x; q < n_parts; q += kThreads)
      if (cnt[q] != 0) atomicAdd(count + q, cnt[q]);
  __syncthreads();
  if (take && list != nullptr)
    list[warp_at[kWarps] + warp_at[warp] + __popc(all & ((1u << lane) - 1u))] = e;
}

// Every thread of the block calls first: empties a stage and the counts.
__device__ __forceinline__ void begin(Stage& s, int* cnt, int n_parts) {
  if (threadIdx.x == 0) s.n = 0;
  if (cnt != nullptr)
    for (int q = threadIdx.x; q < min(n_parts, kSmemParts); q += kThreads) cnt[q] = 0;
  __syncthreads();
}

// Lane k of entry e: lanes_a's, then lanes_b's.
__device__ __forceinline__ int32_t lane_of(const Args& a, int32_t e, int k) {
  return k < a.wa ? a.lanes_a[static_cast<int64_t>(e) * a.wa + k]
                  : a.lanes_b[static_cast<int64_t>(e) * a.wb + (k - a.wa)];
}

// Lanes k0 .. k0 + B of entry e (-1 past the last), 16 or 8 bytes a load
// where they lie in lanes_a and are aligned so. B is a multiple of 4.
template <int B>
__device__ __forceinline__ void row_lanes(const Args& a, int32_t e, int k0, int32_t (&u)[B]) {
  const int k_all = a.wa + a.wb;
  const int32_t* ra = a.lanes_a + static_cast<int64_t>(e) * a.wa;
  const uintptr_t at = reinterpret_cast<uintptr_t>(ra + k0);
#pragma unroll
  for (int j = 0; j < B; j += 4) {
    const int k = k0 + j;
    if (k + 3 < a.wa && (at & 15u) == 0u) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(ra + k));
      u[j] = v.x;
      u[j + 1] = v.y;
      u[j + 2] = v.z;
      u[j + 3] = v.w;
    } else if (k + 3 < a.wa && (at & 7u) == 0u) {
      const int2 v0 = __ldg(reinterpret_cast<const int2*>(ra + k));
      const int2 v1 = __ldg(reinterpret_cast<const int2*>(ra + k + 2));
      u[j] = v0.x;
      u[j + 1] = v0.y;
      u[j + 2] = v1.x;
      u[j + 3] = v1.y;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) u[j + i] = k + i < k_all ? lane_of(a, e, k + i) : -1;
    }
  }
}

// A row's own gid, degree (0 without recolor_degrees) and hash, read once.
struct Own {
  bool have = false;
  int32_t gv = 0, dv = 0;
  uint32_t hv = 0u;
};

__device__ __forceinline__ void own(const Args& a, int32_t e, int32_t p, Own& m) {
  if (m.have) return;
  const int64_t at = static_cast<int64_t>(p) * a.dg_ps + (e - p * a.r_rows);
  m.gv = a.gid[at];
  if (a.recolor_degrees) m.dv = a.deg[at];
  m.hv = coloring::gid_hash(m.gv);
  m.have = true;
}

// The lanes u of row e (from lane k0; those at k_end and beyond do not
// count): colors gathered together, then the gid (and degree) of every
// colliding lane at once.
template <int B>
__device__ __forceinline__ bool batch_loses(const Args& a, int32_t e, int32_t p, int32_t nc,
                                            int k0, int k_end, int32_t (&u)[B], Own& m) {
  const int32_t* nb = a.newc + static_cast<int64_t>(p) * a.r_rows;
  const int32_t* t = a.tab + static_cast<int64_t>(p) * a.tab_ps;
  const int32_t* deg = a.deg + static_cast<int64_t>(p) * a.dg_ps;
  const int32_t* gid = a.gid + static_cast<int64_t>(p) * a.dg_ps;
  int32_t cu[B];
  bool any = false;
#pragma unroll
  for (int j = 0; j < B; ++j) {
    if (k0 + j >= k_end) u[j] = -1;
    cu[j] = u[j] < 0 ? -1 : (u[j] < a.r_rows ? nb[u[j]] : t[u[j]]);
    any |= cu[j] == nc;
  }
  if (!any) return false;
  int32_t gu[B], du[B];
#pragma unroll
  for (int j = 0; j < B; ++j) {
    gu[j] = du[j] = 0;
    if (cu[j] == nc) {
      gu[j] = gid[u[j]];
      if (a.recolor_degrees) du[j] = deg[u[j]];
    }
  }
  own(a, e, p, m);
  bool lose = false;
#pragma unroll
  for (int j = 0; j < B; ++j)
    lose |= cu[j] == nc && gu[j] != m.gv && coloring::v_loses(m.dv, du[j], m.hv, m.gv, gu[j]);
  return lose;
}

// Lanes [k_begin, k_end) of row e, B at a time.
template <int B>
__device__ __forceinline__ bool row_loses(const Args& a, int32_t e, int32_t p, int32_t nc,
                                          int k_begin, int k_end, Own& m) {
  for (int k0 = k_begin; k0 < k_end; k0 += B) {
    int32_t u[B];
    row_lanes<B>(a, e, k0, u);
    if (batch_loses<B>(a, e, p, nc, k0, k_end, u, m)) return true;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads) collision_list_kernel(const Args a) {
  __shared__ Stage act_rows, todo;
  __shared__ int cnt[kSmemParts];
  begin(act_rows, nullptr, 0);
  begin(todo, cnt, a.n_parts);
  const int64_t n_rows = static_cast<int64_t>(a.n_parts) * a.r_rows;
  for (int t = 0; t < a.tiles; ++t) {
    const int64_t e = (static_cast<int64_t>(blockIdx.x) * a.tiles + t) * kThreads;
    if (e >= n_rows) break;                      // the same in every thread
    const int64_t row = e + threadIdx.x;
    bool act = false, uncolored = false;
    int64_t p = 0;
    if (row < n_rows) {
      p = row / a.r_rows;
      const int64_t r = row - p * a.r_rows;
      const int32_t c = a.tab[p * a.tab_ps + r];
      act = a.active[p * a.active_ps + r] != 0;
      uncolored = act && c == 0;
      if (a.newc_out != nullptr) a.newc_out[row] = c;
      if (act && a.base_out != nullptr) a.base_out[row] = 1;
    }
    stage(act_rows, nullptr, nullptr, a.n_parts, act, p, static_cast<int32_t>(row));
    stage(todo, cnt, a.next, a.n_parts, uncolored, p, static_cast<int32_t>(row));
  }
  flush(act_rows, nullptr, a.rows_out, a.next + a.n_parts + 1, nullptr, a.n_parts);
  flush(todo, cnt, a.todo, a.next + a.n_parts, a.next, a.n_parts);
}

// The testing launch (see the design notes above), built for kMin blocks
// an SM: 5 (46 registers) for a dense list, 4 for a sparse one.
template <int kMin>
__global__ void __launch_bounds__(kThreads, kMin) collision_row_kernel(const Args a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == 0)
    for (int q = threadIdx.x; q < a.n_parts + 2; q += kThreads) a.spare[q] = 0;
  const int k_all = a.wa + a.wb;
  int32_t p = 0, e = 0, nc = 0;
  bool run = false;
  int32_t u0[kFirst];
  if (i < a.n_list) {
    e = a.rows[i];
    row_lanes<kFirst>(a, e, 0, u0);
    p = e / a.r_rows;
    run = a.cur[p] > 0;
    nc = run ? a.newc[e] : 0;
  }
  Own m;
  bool lose = nc > 0 && batch_loses<kFirst>(a, e, p, nc, 0, k_all, u0, m);
  const bool going = nc > 0 && !lose && k_all > kFirst;
  unsigned left = __ballot_sync(kFull, going);
  if (__popc(left) > kCoop) {
    if (going) lose = row_loses<8>(a, e, p, nc, kFirst, k_all, m);
  } else if (left != 0u) {
    if (going) own(a, e, p, m);
    constexpr int kPer = 32 / kGroup;          // rows the warp takes side by side
    const int grp = lane / kGroup, t = lane % kGroup;
    while (left != 0u) {
      int src = -1;                            // the row of this thread's group
#pragma unroll
      for (int g = 0; g < kPer; ++g) {
        const int r = left != 0u ? __ffs(left) - 1 : -1;
        if (r >= 0) left &= left - 1u;
        if (g == grp) src = r;
      }
      const int from = src >= 0 ? src : 0;
      const int32_t se = __shfl_sync(kFull, e, from), sp = __shfl_sync(kFull, p, from);
      const int32_t snc = __shfl_sync(kFull, nc, from);
      const int32_t sg = __shfl_sync(kFull, m.gv, from), sd = __shfl_sync(kFull, m.dv, from);
      const uint32_t sh = __shfl_sync(kFull, m.hv, from);
      const int64_t rb = static_cast<int64_t>(sp) * a.r_rows;
      const int64_t tb = static_cast<int64_t>(sp) * a.tab_ps;
      const int64_t db = static_cast<int64_t>(sp) * a.dg_ps;
      bool l = false;
      for (int k0 = kFirst; k0 < k_all; k0 += kGroup * kGroupLanes) {
        int32_t u[kGroupLanes], gu[kGroupLanes], du[kGroupLanes];
        bool hit[kGroupLanes];
#pragma unroll
        for (int j = 0; j < kGroupLanes; ++j) {
          const int k = k0 + t + kGroup * j;
          u[j] = src >= 0 && k < k_all ? lane_of(a, se, k) : -1;
        }
#pragma unroll
        for (int j = 0; j < kGroupLanes; ++j) {
          const int32_t c = u[j] < 0 ? -1 : (u[j] < a.r_rows ? a.newc[rb + u[j]] : a.tab[tb + u[j]]);
          hit[j] = u[j] >= 0 && c == snc;
        }
#pragma unroll
        for (int j = 0; j < kGroupLanes; ++j) {
          gu[j] = du[j] = 0;
          if (hit[j]) {
            gu[j] = a.gid[db + u[j]];
            if (a.recolor_degrees) du[j] = a.deg[db + u[j]];
          }
        }
#pragma unroll
        for (int j = 0; j < kGroupLanes; ++j)
          l |= hit[j] && gu[j] != sg && coloring::v_loses(sd, du[j], sh, sg, gu[j]);
      }
      // Each row taken: the verdict of the group that took it.
      const unsigned verdict = __ballot_sync(kFull, l);
#pragma unroll
      for (int g = 0; g < kPer; ++g) {
        const int r = __shfl_sync(kFull, src, g * kGroup);
        if (r == lane && ((verdict >> (g * kGroup)) & kGroupBits)) lose = true;
      }
    }
  }
  bool uncolored = false;
  if (i < a.n_list) {
    if (run) {
      const int32_t c = lose ? 0 : nc;
      a.tab[static_cast<int64_t>(p) * a.tab_ps + (e - p * a.r_rows)] = c;
      uncolored = c == 0;
    }
    a.lose[i] = static_cast<uint8_t>(lose);
  }
  block_append(a.todo, a.next + a.n_parts, a.next, a.n_parts, uncolored, p, e);
}

}  // namespace

// listing != 0: a listing launch over all P * r_rows rows (reads tab's first
// r_rows entries of each part and active; writes rows_out, todo, next and,
// where given, newc_out and base_out). Else a testing launch over the n_list
// entries of rows (reads lanes_a/lanes_b (P, r_rows, wa/wb) contiguous,
// newc (P, r_rows) contiguous, tab, deg, gid and cur; writes tab at rows of
// running parts, lose, todo, next, and zeroes spare). todo may be null (only
// counted). next must be zeroed. P * r_rows must fit in an int32 and every
// lane must lie in [0, T). Returns cudaGetLastError() after the launch.
extern "C" int collision_launch(const void* lanes_a, int wa, const void* lanes_b, int wb,
                                const void* newc, void* tab, long long tab_ps,
                                const void* deg, const void* gid, long long dg_ps,
                                const void* active, long long active_ps,
                                const void* rows, long long n_list,
                                const void* cur, void* next, void* spare,
                                void* rows_out, void* todo, void* newc_out, void* base_out,
                                void* lose, int listing, int n_parts, int r_rows,
                                int recolor_degrees, void* stream) {
  if (static_cast<int64_t>(n_parts) * r_rows > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.lanes_a = static_cast<const int32_t*>(lanes_a);
  a.lanes_b = static_cast<const int32_t*>(lanes_b);
  a.newc = static_cast<const int32_t*>(newc);
  a.tab = static_cast<int32_t*>(tab);
  a.deg = static_cast<const int32_t*>(deg);
  a.gid = static_cast<const int32_t*>(gid);
  a.active = static_cast<const uint8_t*>(active);
  a.rows = static_cast<const int32_t*>(rows);
  a.cur = static_cast<const int32_t*>(cur);
  a.next = static_cast<int32_t*>(next);
  a.spare = static_cast<int32_t*>(spare);
  a.rows_out = static_cast<int32_t*>(rows_out);
  a.todo = static_cast<int32_t*>(todo);
  a.newc_out = static_cast<int32_t*>(newc_out);
  a.base_out = static_cast<int32_t*>(base_out);
  a.lose = static_cast<uint8_t*>(lose);
  a.tab_ps = tab_ps;
  a.dg_ps = dg_ps;
  a.active_ps = active_ps;
  a.n_list = n_list;
  a.wa = wa;
  a.wb = wb;
  a.n_parts = n_parts;
  a.r_rows = r_rows;
  a.recolor_degrees = recolor_degrees != 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (listing != 0) {
    // Up to kMaxTiles tiles a block, fewer where that leaves the card
    // (132 SMs x 8 blocks) short of blocks.
    const int64_t tiles_all = (static_cast<int64_t>(n_parts) * r_rows + kThreads - 1) / kThreads;
    if (tiles_all == 0) return 0;
    a.tiles = static_cast<int>(std::max<int64_t>(1, std::min<int64_t>(kMaxTiles, tiles_all / 1056)));
    const int64_t blocks = (tiles_all + a.tiles - 1) / a.tiles;
    collision_list_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  } else {
    // One block at least: block 0 zeroes spare even for an empty list.
    const auto blocks = [&](int64_t per) {
      return static_cast<unsigned>(n_list > 0 ? (n_list + per - 1) / per : 1);
    };
    if (n_list * 4 >= static_cast<int64_t>(n_parts) * r_rows) {
      // A dense list (a cold iteration, or d1's every active row): most
      // rows decide on their first lanes, and 5 blocks an SM hide more
      // latency than the registers a row walking its lanes alone would use.
      collision_row_kernel<5><<<blocks(kThreads), kThreads, 0, s>>>(a);
    } else {
      collision_row_kernel<4><<<blocks(kThreads), kThreads, 0, s>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
