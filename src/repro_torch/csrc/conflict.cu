// Algorithm-4 owned-vs-ghost conflict detection for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/conflict.py::_conflict_kernel
// (wrapper conflict_detect). Same function, on the stacked part axis: for
// each part p, row r and lane k, with u = adj[p, r, k], the edge (r, u) is
// a conflict when u is a ghost (n_loc <= u < n_tab), the colors are equal
// and nonzero and the gids differ. The loser is the lower degree (when
// recolor_degrees), then the higher gid_hash, then the higher gid.
//   lose_v[p, r]    = some lane where r loses, and is_boundary[p, r]
//   lose_o[p, r, k] = the lane's conflict is lost by u
//   count[p]       += conflicting lanes of part p
//
// What bounds it on the H100: memory. Every lane reads its int32
// adjacency entry and writes one byte of lose_o, and every row writes one
// byte of lose_v. Everything else is read only where the data needs it:
// the row's color at its first ghost lane, the neighbor's color on ghost
// lanes of a colored row, the row's own gid and degree and the neighbor's
// at lanes whose colors collide, and is_boundary only on a row that loses.
// Rows away from the part boundary (most of them) thus move 4*W + W + 1
// bytes and nothing else.
//
// Design: one thread per (part, row), grid (ceil(N / 256), P). The row's
// own hash is computed once, at its first collision; the count is reduced
// across the warp with shuffles and added to the part's int32 counter
// with one atomicAdd per warp that found a conflict. Integer addition is
// associative, so the count does not depend on the order of the atomics.
// The ragged tail is masked by the row bound (threads past it take part
// in the shuffle with a count of 0); no input is padded.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t gid_hash(int32_t gid) {
  uint32_t x = static_cast<uint32_t>(gid);
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__global__ void conflict_kernel(const int32_t* __restrict__ adj,
                                const int32_t* __restrict__ colors, int64_t colors_ps,
                                const int32_t* __restrict__ deg, int64_t deg_ps,
                                const int32_t* __restrict__ gid, int64_t gid_ps,
                                const uint8_t* __restrict__ boundary, int64_t boundary_ps,
                                const int32_t* __restrict__ ctab,
                                const int32_t* __restrict__ dtab,
                                const int32_t* __restrict__ gtab, int64_t tab_ps,
                                int n_loc, int n_tab, bool recolor_degrees,
                                uint8_t* __restrict__ lose_v,
                                uint8_t* __restrict__ lose_o,
                                int32_t* __restrict__ count,
                                int n, int w) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int64_t p = blockIdx.y;
  int found = 0;
  if (r < n) {
    const int64_t row_ix = p * n + r;
    const int32_t* row = adj + row_ix * w;
    uint8_t* lo = lose_o + row_ix * w;
    const int64_t t0 = p * tab_ps;
    bool have_cv = false, have_own = false, v_any = false;
    int32_t cv = 0, dv = 0, gv = 0;
    uint32_t hv = 0u;
    for (int k = 0; k < w; ++k) {
      const int32_t u = row[k];
      bool o_loses = false;
      if (u >= n_loc && u < n_tab) {                 // a ghost lane
        if (!have_cv) {
          cv = colors[p * colors_ps + r];
          have_cv = true;
        }
        if (cv > 0 && ctab[t0 + u] == cv) {          // colors collide
          if (!have_own) {
            gv = gid[p * gid_ps + r];
            if (recolor_degrees) dv = deg[p * deg_ps + r];
            hv = gid_hash(gv);
            have_own = true;
          }
          const int32_t gu = gtab[t0 + u];
          if (gu != gv) {
            bool v_rule;
            const int32_t du = recolor_degrees ? dtab[t0 + u] : dv;
            if (du != dv) {
              v_rule = dv < du;
            } else {
              const uint32_t hu = gid_hash(gu);
              v_rule = (hv != hu) ? (hv > hu) : (gv > gu);
            }
            v_any |= v_rule;
            o_loses = !v_rule;
            ++found;
          }
        }
      }
      lo[k] = o_loses ? 1 : 0;
    }
    // && reads is_boundary only for a row that loses on some lane.
    lose_v[row_ix] = (v_any && boundary[p * boundary_ps + r] != 0) ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1)
    found += __shfl_down_sync(0xFFFFFFFFu, found, off);
  if ((threadIdx.x & 31) == 0 && found != 0) atomicAdd(count + p, found);
}

}  // namespace

// Row arrays (colors, deg, gid, is_boundary) and the three tables may be
// strided over the part axis; their row axis is contiguous, and the three
// tables share one part stride. adj and lose_o are contiguous (P, N, W),
// lose_v is contiguous (P, N). count (P,) must be zeroed by the caller.
// Returns cudaGetLastError() after the launch.
extern "C" int conflict_detect_launch(const void* adj,
                                      const void* colors, long long colors_ps,
                                      const void* deg, long long deg_ps,
                                      const void* gid, long long gid_ps,
                                      const void* boundary, long long boundary_ps,
                                      const void* ctab, const void* dtab,
                                      const void* gtab, long long tab_ps,
                                      int n_loc, int n_tab, int recolor_degrees,
                                      void* lose_v, void* lose_o, void* count,
                                      int n_parts, int n, int w, void* stream) {
  if (n_parts == 0 || n == 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads, n_parts);
  conflict_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(adj),
      static_cast<const int32_t*>(colors), colors_ps,
      static_cast<const int32_t*>(deg), deg_ps,
      static_cast<const int32_t*>(gid), gid_ps,
      static_cast<const uint8_t*>(boundary), boundary_ps,
      static_cast<const int32_t*>(ctab), static_cast<const int32_t*>(dtab),
      static_cast<const int32_t*>(gtab), tab_ps,
      n_loc, n_tab, recolor_degrees != 0,
      static_cast<uint8_t*>(lose_v), static_cast<uint8_t*>(lose_o),
      static_cast<int32_t*>(count), n, w);
  return static_cast<int>(cudaGetLastError());
}
