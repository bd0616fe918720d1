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
// Design: one thread per entry (testing) or per row (listing), a flat grid;
// a listing block walks up to 16 consecutive tiles of 256 rows (fewer where
// that would leave the card short of blocks).
// - The result does not depend on the order of the list: a testing launch
//   reads rows' colors from newc only and writes the table only at rows, so
//   no thread reads what another writes (the table's ghost and pad entries,
//   which it does read, are never written). This holds on asymmetric lanes,
//   where an old colored row can lose to a row colored in this iteration.
// - Lanes are read kBatch at a time and their colors gathered together, so
//   their loads overlap; the row's own gid, hash and degree are read once,
//   at its first colliding lane; the row stops at its first losing lane.
//   Reading the gids of a batch's colliding lanes together measured slower
//   on the H100: most rows of a cold iteration lose at one of their first
//   lanes.
// - A testing launch appends warp by warp: one atomicAdd per warp on the
//   list's cursor, one per part present in the warp (__match_any_sync) on
//   the counts. A listing launch, which does little else, stages the
//   entries a block appends over its tiles in shared memory (in tile, warp
//   and lane order), takes their places with one atomicAdd per list at its
//   end and writes them out contiguously; its per-part counts gather in
//   shared memory. Appending warp by warp there serialised on the two
//   cursors and took several times longer on the H100.
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
constexpr int kBatch = 8;          // lanes gathered at once

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

// Every lane of the warp calls: appends e, where `take`, to `list` (if any)
// at the cursor *len, with one atomicAdd per warp, and adds the appended
// entries per part into count[p], one atomicAdd per part in the warp.
__device__ __forceinline__ void append(int32_t* list, int32_t* len, int32_t* count,
                                       bool take, int64_t p, int32_t e) {
  const unsigned all = __ballot_sync(0xFFFFFFFFu, take);
  if (all == 0u) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(all) - 1;
  int at = 0;
  if (lane == leader) at = atomicAdd(len, __popc(all));
  at = __shfl_sync(0xFFFFFFFFu, at, leader);
  if (take && list != nullptr) list[at + __popc(all & ((1u << lane) - 1u))] = e;
  const unsigned same = __match_any_sync(0xFFFFFFFFu, take ? static_cast<int>(p) : -1);
  if (take && lane == __ffs(same) - 1) atomicAdd(count + p, __popc(same));
}

// Every thread of the block calls first: empties a stage and the counts.
__device__ __forceinline__ void begin(Stage& s, int* cnt, int n_parts) {
  if (threadIdx.x == 0) s.n = 0;
  if (cnt != nullptr)
    for (int q = threadIdx.x; q < min(n_parts, kSmemParts); q += kThreads) cnt[q] = 0;
  __syncthreads();
}

// The row's own gid, hash and degree, read at its first colliding lane.
struct Own {
  bool have = false;
  int32_t dv = 0, gv = 0;
  uint32_t hv = 0u;
};

// True where the row r of part p with new color nc loses to a lane of one
// block: the lanes are read kBatch at a time, and their colors gathered
// together (rows from newc, ghosts and pad from the table).
__device__ __forceinline__ bool loses(const Args& a, const int32_t* lanes, int k_lanes,
                                      int64_t p, int r, int32_t nc, Own& own) {
  const int32_t* nb = a.newc + p * a.r_rows;
  const int32_t* t = a.tab + p * a.tab_ps;
  const int32_t* deg = a.deg + p * a.dg_ps;
  const int32_t* gid = a.gid + p * a.dg_ps;
  for (int k0 = 0; k0 < k_lanes; k0 += kBatch) {
    int32_t u[kBatch], cu[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) u[j] = k0 + j < k_lanes ? lanes[k0 + j] : -1;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const bool row = u[j] >= 0 && u[j] < a.r_rows;
      const int32_t cr = row ? nb[u[j]] : 0;
      const int32_t ct = u[j] >= a.r_rows ? t[u[j]] : 0;
      cu[j] = row ? cr : ct;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (cu[j] != nc) continue;
      if (!own.have) {
        own.gv = gid[r];
        if (a.recolor_degrees) own.dv = deg[r];
        own.hv = coloring::gid_hash(own.gv);
        own.have = true;
      }
      const int32_t gu = gid[u[j]];
      if (gu == own.gv) continue;
      const int32_t du = a.recolor_degrees ? deg[u[j]] : own.dv;
      if (coloring::v_loses(own.dv, du, own.hv, own.gv, gu)) return true;
    }
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

__global__ void __launch_bounds__(kThreads) collision_test_kernel(const Args a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (blockIdx.x == 0)
    for (int q = threadIdx.x; q < a.n_parts + 2; q += kThreads) a.spare[q] = 0;
  bool uncolored = false;
  int64_t p = 0;
  int32_t e = 0;
  if (i < a.n_list) {
    e = a.rows[i];
    p = e / a.r_rows;
    bool lose = false;
    if (a.cur[p] > 0) {
      const int r = static_cast<int>(e - p * a.r_rows);
      const int32_t nc = a.newc[e];
      if (nc > 0) {
        Own own;
        lose = loses(a, a.lanes_a + static_cast<int64_t>(e) * a.wa, a.wa, p, r, nc, own);
        if (!lose && a.lanes_b != nullptr)
          lose = loses(a, a.lanes_b + static_cast<int64_t>(e) * a.wb, a.wb, p, r, nc, own);
      }
      const int32_t c = lose ? 0 : nc;
      a.tab[p * a.tab_ps + r] = c;
      uncolored = c == 0;
    }
    a.lose[i] = static_cast<uint8_t>(lose);
  }
  append(a.todo, a.next + a.n_parts, a.next, uncolored, p, e);
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
    const int64_t blocks = n_list > 0 ? (n_list + kThreads - 1) / kThreads : 1;
    collision_test_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
