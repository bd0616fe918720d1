// Causal or full GQA attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (kernel body _flash_kernel). Same function: for q (B, Lq, Hq, dh) and k, v
// (B, Lk, Hkv, dh), fp32 or bf16, query head h of batch b reads kv head
// h / (Hq / Hkv) of batch b (K and V are never repeated), and
//
//   o[b, i, h] = sum_j softmax_j(s_ij) v[b, j, h / g],  s_ij = (q_i * dh^-0.5) . k_j
//
// with key j visible to query i iff j <= i when causal (top-left aligned;
// masked scores are -1e30, not -inf), fp32 running max, sum and accumulator,
// the division acc / max(l, 1e-30), and the output in q's dtype.
//
// The TPU kernel transposes q, k, v to (B*H, L, dh) and walks one (head,
// q-tile) pair per sequential grid step. Here the (B, L, H, dh) layout is
// read in place (row stride H*dh, contiguous last axis), and every
// (batch*q-head, query tile) pair is one block of a flat grid.x, so
// batch*heads has no limit of its own; blocks are issued heaviest causal
// tile first, and within a tile the q heads of one kv head follow each
// other, so their K and V are read from L2. Every body visits the key
// tiles in order from key 0, so a row's first tile holds a visible key and
// a masked key adds exactly 0 (exp(-1e30 - m) = 0); causal blocks stop at
// the last key tile their rows can see. Three bodies:
//
// - bf16 with dh 64 or 128 (the served model's prefill; flash_wgmma_kernel):
//   what bounds it on the H100 is the two products, 4 * dh flops per
//   visible (query, key) pair, over the tensor cores' 989 TFLOP/s dense
//   bf16 rate (the bytes, q, k, v read once and o written once at 3.35
//   TB/s, bound it far less), and that rate is reached only by wgmma fed
//   from shared memory while the next tiles load. So a block of three
//   warpgroups owns 128 queries: one producer warp issues TMA loads (q
//   once; K and V tiles of 128 keys into a ring of 3 stages, 128-byte
//   swizzled, each stage with full and empty mbarriers) and gives its
//   registers away (setmaxnreg); two consumer warpgroups of 64 queries each
//   run S = Q.K^T as wgmma m64n128k16 (Q and K from shared memory, both
//   K-major as they lie in memory) and O += P.V as wgmma m64n{dh}k16 with
//   P from registers (the accumulator layout of the first product is the A
//   layout of the second) and V from shared memory as an MN-major operand
//   (the transpose bit), so V is never transposed. The two consumers run
//   unsynchronised, so one's softmax overlaps the other's products (a
//   consumer's own next S issued before its P.V would need a second score
//   tile of registers: at the 168 registers a thread of a 384-thread block
//   gets, ptxas spills it). Scores are scaled by dh^-0.5 * log2(e) inside
//   the one fused multiply-add that also subtracts the running max, and
//   exponentiated with ex2; only the tiles that cross the causal diagonal
//   or the end of the keys are masked. The tensor maps are encoded per call
//   through cuTensorMapEncodeTiled, reached with cudaGetDriverEntryPoint,
//   so the library links only the CUDA runtime.
// - bf16 with dh 16, 32 and 80 (flash_mma_kernel): both products as
//   mma.sync m16n8k16, one warp per 16 of a block's 64 query rows, K and a
//   transposed V in shared memory loaded by the same warps. dh 80 rows are
//   160 bytes, wider than one 128-byte swizzle row, and dh 16 and 32 are
//   too narrow to fill a wgmma tile's loads, so they keep this body.
// - fp32, and bf16 with dh 8 (flash_kernel): CUDA cores in fp32. Four
//   threads own one query row: each holds a quarter of the row's dh (in
//   interleaved 4-wide vectors, so the four read neighbouring shared-memory
//   words) of the scaled query and of the accumulator in registers, and a
//   score is their partial dot products summed by two warp shuffles; K and
//   V are converted to fp32 on load and the online softmax updates once
//   per 16 keys.
//
// In both bf16 bodies the probabilities are rounded to bf16 before the
// second product, as the model's attention and SDPA round them. This is a
// lower precision than _flash_kernel's: the TPU kernel upcasts k and v to
// fp32 and computes p @ v with p in fp32, so its P.V product rounds
// nothing. Making a body faster does not license more rounding on that
// ground.
#include <climits>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;                 // queries per block (CUDA-core and mma.sync bodies)
constexpr int kTpr = 4;                   // threads per query row
constexpr int kThreads = kRows * kTpr;    // 256
constexpr int kKeys = 64;                 // keys per shared-memory tile
constexpr int kChunk = 16;                // keys per online-softmax update
constexpr float kNegInf = -1e30f;

// The block's (batch, q head, query tile) on the flat grid: the heaviest
// causal tiles first, every (batch, head) pair of a tile in a row.
__device__ __forceinline__ void block_tile(int hq, int bh_count, int n_qtiles, int& b, int& h,
                                           int& qtile) {
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  qtile = n_qtiles - 1 - static_cast<int>(blockIdx.x / bh_count);
  b = bh / hq;
  h = bh % hq;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four bf16 values (8 bytes) widened to fp32: a bf16 is the top half of
// its fp32 value, element 0 in the low half of the first word.
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// VEC consecutive fp32 words from shared memory (VEC is 2 or 4, aligned).
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int lq, int lk, int hq, int hkv, int bh_count, int n_qtiles,
             int causal, float scale) {
  constexpr int VEC = DH / kTpr >= 4 ? 4 : DH / kTpr;   // words per vector
  constexpr int NV = DH / (kTpr * VEC);                  // vectors per thread
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);           // [kKeys][DH]
  float* vs = ks + kKeys * DH;                           // [kKeys][DH]

  int b, h, qtile;
  block_tile(hq, bh_count, n_qtiles, b, h, qtile);
  const int kvh = h / (hq / hkv);
  const int row = threadIdx.x / kTpr, t = threadIdx.x % kTpr;
  const int qi = qtile * kRows + row;
  const bool live = qi < lq;
  const int64_t q_rs = static_cast<int64_t>(hq) * DH;    // row stride of q and o
  const int64_t kv_rs = static_cast<int64_t>(hkv) * DH;  // row stride of k and v

  // This thread's dims: vector c covers dh[(c*kTpr + t)*VEC, +VEC).
  const int64_t q_off = (static_cast<int64_t>(b) * lq + (live ? qi : 0)) * q_rs +
                        static_cast<int64_t>(h) * DH;
  float qf[NV][VEC], acc[NV][VEC];
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qf[c][e] = live ? to_f32(q[q_off + (c * kTpr + t) * VEC + e]) * scale : 0.f;
      acc[c][e] = 0.f;
    }
  float m = kNegInf, l = 0.f;

  const int last_q = min(lq, (qtile + 1) * kRows) - 1;   // the block's last live row
  int n_tiles = (lk + kKeys - 1) / kKeys;
  if (causal) n_tiles = min(n_tiles, last_q / kKeys + 1);
  const T* kb = k + static_cast<int64_t>(b) * lk * kv_rs + static_cast<int64_t>(kvh) * DH;
  const T* vb = v + static_cast<int64_t>(b) * lk * kv_rs + static_cast<int64_t>(kvh) * DH;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kKeys;
    __syncthreads();                                     // the last tile is consumed
    for (int i = threadIdx.x; i < kKeys * DH / 4; i += kThreads) {
      const int j = i / (DH / 4), d = (i % (DH / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;   // keys past lk: zeros
      if (k0 + j < lk) {
        kx = load4(kb + (k0 + j) * kv_rs + d);
        vx = load4(vb + (k0 + j) * kv_rs + d);
      }
      reinterpret_cast<float4*>(ks)[i] = kx;
      reinterpret_cast<float4*>(vs)[i] = vx;
    }
    __syncthreads();

    for (int c0 = 0; c0 < kKeys; c0 += kChunk) {
      if (k0 + c0 >= lk || (causal && k0 + c0 > last_q)) break;   // no row sees it
      float s[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* kr = ks + (c0 + j) * DH;
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          float kv[VEC];
          load_vec<VEC>(kr + (c * kTpr + t) * VEC, kv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) part = fmaf(qf[c][e], kv[e], part);
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        const int key = k0 + c0 + j;
        s[j] = (key < lk && (!causal || key <= qi)) ? part : kNegInf;
      }
      float m_new = m;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) m_new = fmaxf(m_new, s[j]);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] = expf(s[j] - m_new);
        psum += s[j];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int c = 0; c < NV; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[c][e] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* vr = vs + (c0 + j) * DH;
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          float vv[VEC];
          load_vec<VEC>(vr + (c * kTpr + t) * VEC, vv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[c][e] = fmaf(s[j], vv[e], acc[c][e]);
        }
      }
      m = m_new;
    }
  }

  if (!live) return;
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int e = 0; e < VEC; ++e) store(o + q_off + (c * kTpr + t) * VEC + e, acc[c][e] / den);
}

// ---- bf16 on the tensor cores with mma.sync (dh 16, 32, 80) ----------------
//
// The same function with both products as mma.sync m16n8k16 (bf16 in, fp32
// accumulate). A block has four warps, one per 16 of its 64 query rows;
// a warp keeps its unscaled bf16 query rows as A fragments and its
// (16, dh) fp32 accumulator in registers. K (64 keys, row-major) and V
// (transposed to (dh, 64 keys)) stream through shared memory as bf16,
// their rows padded by 8 so that the fragment loads hit 32 distinct banks.
// A warp computes a (16, 64) score tile, scales and masks it in fp32,
// updates the running max and sum for its rows (the four lanes that share
// a row agree through two shuffles), and rounds the probabilities to bf16
// as the A fragments of the second product: the accumulator layout of the
// first product is the A layout of the second. The row sums stay partial
// per lane (each lane's share of the columns, all rescaled alike) and are
// summed over the four lanes at the end.

constexpr int kWarps = kRows / 16;          // 4
constexpr int kMmaThreads = kWarps * 32;    // 128

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values as bf16x2, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int lq,
                 int lk, int hq, int hkv, int bh_count, int n_qtiles, int causal, float scale) {
  constexpr int KS = DH + 8;                // K row stride in shared memory
  constexpr int VS = kKeys + 8;             // transposed V row stride
  constexpr int KK = DH / 16;               // k-steps of the first product
  constexpr int ND = DH / 8;                // n-tiles of the second
  __shared__ __align__(16) __nv_bfloat16 ks[kKeys * KS];
  __shared__ __align__(16) __nv_bfloat16 vts[DH * VS];

  int b, h, qtile;
  block_tile(hq, bh_count, n_qtiles, b, h, qtile);
  const int kvh = h / (hq / hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;                  // fragment row group, column pair
  const int r0 = qtile * kRows + warp * 16;              // the warp's first query row
  const int row[2] = {r0 + g, r0 + g + 8};
  const int64_t q_rs = static_cast<int64_t>(hq) * DH;
  const int64_t kv_rs = static_cast<int64_t>(hkv) * DH;
  const __nv_bfloat16* qb = q + static_cast<int64_t>(b) * lq * q_rs + static_cast<int64_t>(h) * DH;

  uint32_t qa[KK][4];                       // A fragments: rows g, g+8; columns 2t, 2t+8
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = row[r & 1];
      qa[kk][r] = i < lq ? ld32(qb + i * q_rs + kk * 16 + 2 * t + 8 * (r >> 1)) : 0u;
    }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int last_q = min(lq, (qtile + 1) * kRows) - 1;
  int n_tiles = (lk + kKeys - 1) / kKeys;
  if (causal) n_tiles = min(n_tiles, last_q / kKeys + 1);
  const __nv_bfloat16* kb = k + static_cast<int64_t>(b) * lk * kv_rs + static_cast<int64_t>(kvh) * DH;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(b) * lk * kv_rs + static_cast<int64_t>(kvh) * DH;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kKeys;
    __syncthreads();                                     // the last tile is consumed
    for (int i = threadIdx.x; i < kKeys * DH / 8; i += kMmaThreads) {
      const int j = i / (DH / 8), d = (i % (DH / 8)) * 8;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;    // keys past lk: zeros
      if (k0 + j < lk) {
        kx = *reinterpret_cast<const uint4*>(kb + (k0 + j) * kv_rs + d);
        vx = *reinterpret_cast<const uint4*>(vb + (k0 + j) * kv_rs + d);
      }
      *reinterpret_cast<uint4*>(ks + j * KS + d) = kx;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vx);
#pragma unroll
      for (int e = 0; e < 8; ++e) vts[(d + e) * VS + j] = ve[e];
    }
    __syncthreads();
    if (causal && k0 > r0 + 15) continue;                // above the warp's diagonal

    float s[8][4];                                       // (16, 64) scores, C layout
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = ks + (n * 8 + g) * KS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) mma_bf16(s[n], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = k0 + n * 8 + 2 * t + (r & 1);
        const bool ok = key < lk && (!causal || key <= row[r >> 1]);
        s[n][r] = ok ? s[n][r] * scale : kNegInf;
        mx[r >> 1] = fmaxf(mx[r >> 1], s[n][r]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      alpha[hr] = expf(m[hr] - mx[hr]);
      m[hr] = mx[hr];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[n][r] = expf(s[n][r] - m[r >> 1]);
        sum[r >> 1] += s[n][r];
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * alpha[hr] + sum[hr];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {            // keys 16kk .. 16kk + 15
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vr = vts + (n * 8 + g) * VS + kk * 16 + 2 * t;
        mma_bf16(acc[n], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
  __nv_bfloat16* ob = o + static_cast<int64_t>(b) * lq * q_rs + static_cast<int64_t>(h) * DH;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (row[hr] >= lq) continue;
    const float den = fmaxf(l[hr], 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(ob + row[hr] * q_rs + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * hr] / den, acc[n][2 * hr + 1] / den);
  }
}

// ---- bf16 with wgmma and TMA (dh 64, 128) ---------------------------------
//
// Shared memory holds every tile as rows of 64 bf16 (128 bytes), 128-byte
// swizzled by TMA, in 1024-byte-aligned regions: a dh-128 tile is two such
// column halves, one after the other. A wgmma descriptor names a region's
// start, the byte stride between 8-row groups (SBO, 1024) and, for the
// MN-major V, the stride between its column halves (LBO); a k-step of 16
// bf16 inside a swizzled row advances the start by 32 bytes.
//
// Accumulator layout of wgmma m64nN (fp32): in warp w of a warpgroup, lane
// (g = lane / 4, t = lane % 4) holds d[4j + r] = element (16w + g + 8 (r / 2),
// 8j + 2t + r % 2), for j < N / 8: the layout mma.sync's C fragment has in
// every 8-column block. The A registers of wgmma with A in registers take
// the layout of mma.sync's A fragment, so a k-step's four words are the
// probabilities of two neighbouring 8-column blocks of the scores.

constexpr int kWgThreads = 128;                        // a warpgroup
constexpr int kConsumers = 2;                          // consumer warpgroups
constexpr int kWgRows = 64;                            // queries per consumer
constexpr int kBlockQ = kWgRows * kConsumers;          // 128 queries per block
constexpr int kBlockK = 128;                           // keys per TMA tile
constexpr int kWgmmaThreads = kWgThreads * (1 + kConsumers);   // 384
constexpr int kSwRow = 128;                            // bytes of a swizzled row
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct WgmmaSmem {
  static constexpr int kHalves = DH / 64;              // 64-column halves of a row
  static constexpr int kStages = 3;                    // K/V ring depth
  static constexpr int kQBytes = kConsumers * kHalves * kWgRows * kSwRow;
  static constexpr int kTileBytes = kHalves * kBlockK * kSwRow;   // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  // barriers: q_full, k_full[kStages], v_full[kStages], empty[kStages];
  // 1024 bytes of slack to align the base.
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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

// TMA: the box at coordinates (c0, c1, c2, c3) of a 4-d tensor map into
// shared memory at dst, completing on the barrier.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled region.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products that own them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D (64 x 128, fp32) (+)= A (64 x 16, smem) . B (16 x 128, smem), both
// K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 registers) . B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 registers) . B (16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// S = Q . K^T of one key tile over dh in k-steps of 16: issued and
// committed as one group, not waited for.
template <int DH>
__device__ __forceinline__ void issue_scores(float (&s)[kBlockK / 2], uint32_t q_c,
                                             uint32_t k_t) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss_n128(s, sw128_desc(q_c + (kk / 4) * kWgRows * kSwRow + (kk % 4) * 32, 16, 1024),
                  sw128_desc(k_t + (kk / 4) * kBlockK * kSwRow + (kk % 4) * 32, 16, 1024),
                  kk > 0);
  wgmma_commit();
}

// What a consumer thread's softmax needs to know of its rows.
struct Tile {
  int lk, causal, r_lo, row0, t4;   // row0: the thread's first row (the second is + 8)
  float scale_log2;
};

// One key tile's online softmax for the thread's two rows: mask (only a
// tile that crosses the diagonal or the end of the keys; a masked score
// is -1e30 before the scale), take the row max of the raw scores (the
// scale is positive), keep the running max m in the log2 domain, and form
// p = 2^(s * dh^-0.5 log2(e) - m) with one fused multiply-add per score;
// update the running sum l, return the accumulator's rescale alpha, and
// round P to bf16 in the A layout of P . V.
__device__ __forceinline__ void softmax_tile(float (&s)[kBlockK / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             uint32_t (&pa)[kBlockK / 16][4], int k0,
                                             const Tile& tl) {
  if (k0 + kBlockK > tl.lk || (tl.causal && k0 + kBlockK - 1 > tl.r_lo)) {
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = k0 + 8 * j + 2 * tl.t4 + (r & 1);
        if (!(key < tl.lk && (!tl.causal || key <= tl.row0 + 8 * (r >> 1))))
          s[4 * j + r] = kNegInf;
      }
  }
  float mx[2] = {kNegInf, kNegInf}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kBlockK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float neg_m[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    const float m_new = fmaxf(m[hr], mx[hr] * tl.scale_log2);
    alpha[hr] = ex2(m[hr] - m_new);
    m[hr] = m_new;
    neg_m[hr] = -m_new;
  }
#pragma unroll
  for (int i = 0; i < kBlockK / 2; ++i) {
    s[i] = ex2(fmaf(s[i], tl.scale_log2, neg_m[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * alpha[hr] + sum[hr];
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

template <int DH>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o, int lq,
                   int lk, int hq, int hkv, int bh_count, int n_qtiles, int causal,
                   float scale_log2) {
  using L = WgmmaSmem<DH>;
  constexpr int H = L::kHalves, S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::kQ, k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * S, empty = v_full + 8 * S;

  int b, h, qtile;
  block_tile(hq, bh_count, n_qtiles, b, h, qtile);
  const int q0 = qtile * kBlockQ;
  const int last_q = min(lq, q0 + kBlockQ) - 1;
  int n_tiles = (lk + kBlockK - 1) / kBlockK;
  if (causal) n_tiles = min(n_tiles, last_q / kBlockK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers * kWgThreads / 32);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 0) {
    // The producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    const int kvh = h / (hq / hkv);
    mbar_expect_tx(q_full, L::kQBytes);
    for (int c = 0; c < kConsumers; ++c)
      for (int hf = 0; hf < H; ++hf)
        tma_load_4d(q_s + (c * H + hf) * kWgRows * kSwRow, &tm_q, q_full, hf * 64, h,
                    q0 + c * kWgRows, b);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % S;
      mbar_wait(empty + 8 * s, ((t / S) & 1) ^ 1);     // passes at once on the first round
      mbar_expect_tx(k_full + 8 * s, L::kTileBytes);
      for (int hf = 0; hf < H; ++hf)
        tma_load_4d(k_s + s * L::kTileBytes + hf * kBlockK * kSwRow, &tm_k, k_full + 8 * s,
                    hf * 64, kvh, t * kBlockK, b);
      mbar_expect_tx(v_full + 8 * s, L::kTileBytes);
      for (int hf = 0; hf < H; ++hf)
        tma_load_4d(v_s + s * L::kTileBytes + hf * kBlockK * kSwRow, &tm_v, v_full + 8 * s,
                    hf * 64, kvh, t * kBlockK, b);
    }
    return;
  }

  // A consumer: 64 query rows, 16 per warp.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r_lo = q0 + c * kWgRows + warp * 16;       // the warp's first row
  const int row[2] = {r_lo + g, r_lo + g + 8};
  const uint32_t q_c = q_s + c * H * kWgRows * kSwRow;

  float acc[DH / 2], s[kBlockK / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBlockK / 2; ++i) s[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t pa[kBlockK / 16][4];                        // P in bf16, A layout per k-step
  const Tile tile{lk, causal, r_lo, row[0], t4, scale_log2};
  mbar_wait(q_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % S;
    const uint32_t par = (t / S) & 1;
    mbar_wait(k_full + 8 * st, par);
    issue_scores<DH>(s, q_c, k_s + st * L::kTileBytes);
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(s, m, l, alpha, pa, t * kBlockK, tile);
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P . V over the tile's keys in k-steps of 16.
    mbar_wait(v_full + 8 * st, par);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk)
      wgmma_rs(acc, pa[kk],
               sw128_desc(v_s + st * L::kTileBytes + kk * 16 * kSwRow, kBlockK * kSwRow, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
  const int64_t q_rs = static_cast<int64_t>(hq) * DH;
  __nv_bfloat16* ob = o + static_cast<int64_t>(b) * lq * q_rs + static_cast<int64_t>(h) * DH;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (row[hr] >= lq) continue;
    const float den = fmaxf(l[hr], 1e-30f);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<uint32_t*>(ob + row[hr] * q_rs + n * 8 + 2 * t4) =
          pack_bf16(acc[4 * n + 2 * hr] / den, acc[4 * n + 2 * hr + 1] / den);
  }
}

// cuTensorMapEncodeTiled, a driver function, through the runtime's entry
// point query: the library links no libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map over a bf16 (B, L, H, DH) tensor as it lies in memory, with
// boxes of (64 columns, 1 head, `rows` rows, 1 batch), 128-byte swizzled;
// rows past L read as zeros.
bool tensor_map(EncodeTiled fn, CUtensorMap* map, const void* ptr, int batch, int len, int heads,
                int dh, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(len), static_cast<cuuint64_t>(batch)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(dh) * 2;
  const cuuint64_t strides[3] = {row_bytes, row_bytes * heads, row_bytes * heads * len};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// Blocks of a flat grid of (batch*q-head, query tile) pairs.
int flat_blocks(int batch, int hq, int lq, int block_rows, int& n_qtiles) {
  n_qtiles = (lq + block_rows - 1) / block_rows;
  const int64_t blocks = static_cast<int64_t>(n_qtiles) * batch * hq;
  return blocks > INT_MAX ? -1 : static_cast<int>(blocks);
}

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int batch, int lq, int lk,
                 int hq, int hkv, int causal, float scale, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tq, tk, tv;
  if (!tensor_map(fn, &tq, q, batch, lq, hq, DH, kWgRows) ||
      !tensor_map(fn, &tk, k, batch, lk, hkv, DH, kBlockK) ||
      !tensor_map(fn, &tv, v, batch, lk, hkv, DH, kBlockK))
    return static_cast<int>(cudaErrorInvalidValue);
  int n_qtiles;
  const int blocks = flat_blocks(batch, hq, lq, kBlockQ, n_qtiles);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int smem = WgmmaSmem<DH>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_wgmma_kernel<DH><<<blocks, kWgmmaThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lq, lk, hq, hkv, batch * hq, n_qtiles, causal,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, void* o, int batch, int lq, int lk,
               int hq, int hkv, int causal, float scale, cudaStream_t stream) {
  int n_qtiles;
  const int blocks = flat_blocks(batch, hq, lq, kRows, n_qtiles);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_mma_kernel<DH><<<blocks, kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lq, lk, hq, hkv,
      batch * hq, n_qtiles, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int lq, int lk,
           int hq, int hkv, int causal, float scale, cudaStream_t stream) {
  const int smem = 2 * kKeys * DH * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_qtiles;
  const int blocks = flat_blocks(batch, hq, lq, kRows, n_qtiles);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_kernel<T, DH><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lq, lk, hq, hkv, batch * hq, n_qtiles, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_fp32(int dh, const void* q, const void* k, const void* v, void* o, int batch,
                int lq, int lk, int hq, int hkv, int causal, float scale, cudaStream_t st) {
  switch (dh) {
    case 8: return launch<float, 8>(q, k, v, o, batch, lq, lk, hq, hkv, causal, scale, st);
    case 16: return launch<float, 16>(q, k, v, o, batch, lq, lk, hq, hkv, causal, scale, st);
    case 32: return launch<float, 32>(q, k, v, o, batch, lq, lk, hq, hkv, causal, scale, st);
    case 64: return launch<float, 64>(q, k, v, o, batch, lq, lk, hq, hkv, causal, scale, st);
    case 80: return launch<float, 80>(q, k, v, o, batch, lq, lk, hq, hkv, causal, scale, st);
    case 128: return launch<float, 128>(q, k, v, o, batch, lq, lk, hq, hkv, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_bf16(int dh, const void* q, const void* k, const void* v, void* o, int batch,
                int lq, int lk, int hq, int hkv, int causal, float scale, cudaStream_t st) {
  switch (dh) {   // dh 8 is below one k-step of 16: the CUDA-core body
    case 8:
      return launch<__nv_bfloat16, 8>(q, k, v, o, batch, lq, lk, hq, hkv, causal, scale, st);
    case 16: return launch_mma<16>(q, k, v, o, batch, lq, lk, hq, hkv, causal, scale, st);
    case 32: return launch_mma<32>(q, k, v, o, batch, lq, lk, hq, hkv, causal, scale, st);
    case 64: return launch_wgmma<64>(q, k, v, o, batch, lq, lk, hq, hkv, causal, scale, st);
    case 80: return launch_mma<80>(q, k, v, o, batch, lq, lk, hq, hkv, causal, scale, st);
    case 128: return launch_wgmma<128>(q, k, v, o, batch, lq, lk, hq, hkv, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Lq, Hq, dh), k and v (B, Lk, Hkv, dh), o like q: contiguous, of one
// dtype (bf16 when is_bf16, else fp32), 16-byte aligned; dh in {8, 16, 32,
// 64, 80, 128}; Hq a multiple of Hkv; Lk >= 1. Launches on `stream` and returns the
// CUDA error of the launch (cudaGetLastError()), cudaErrorInvalidValue for
// a dh it was not built for or a tensor map the driver refuses,
// cudaErrorSymbolNotFound when the driver has no cuTensorMapEncodeTiled,
// or cudaErrorInvalidConfiguration for more than INT_MAX blocks.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int batch, int lq, int lk, int hq, int hkv, int dh,
                                      int is_bf16, int causal, float scale, void* stream) {
  if (batch == 0 || lq == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (is_bf16 ? launch_bf16 : launch_fp32)(dh, q, k, v, o, batch, lq, lk, hq, hkv, causal,
                                               scale, st);
}
