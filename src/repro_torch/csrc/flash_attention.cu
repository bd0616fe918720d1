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
// (batch*q-head, 64-query tile) pair is one block, run in parallel; K and V
// stream through shared memory in tiles of 64 keys. Causal blocks stop at
// the last key tile their rows can see: a tile wholly above the diagonal
// adds exactly 0 once key 0 was seen. Blocks are issued heaviest causal
// tile first. Two bodies:
//
// - bf16 with dh >= 16 (the served model's prefill): both products on the
//   tensor cores as mma.sync m16n8k16, one warp per 16 query rows (see
//   flash_mma_kernel); the scale multiplies the fp32 scores, since
//   scaling the bf16 query would round it again for dh 32 and 128, and the
//   probabilities are rounded to bf16 before the second product, as the
//   model's attention and SDPA round them. This is a lower precision than
//   _flash_kernel's: the TPU kernel upcasts k and v to fp32 and computes
//   p @ v with p in fp32, so its P.V product rounds nothing. Making this
//   body faster does not license more rounding on that ground.
// - fp32, and bf16 with dh 8: CUDA cores in fp32. Four threads own one
//   query row: each holds a quarter of the row's dh (in interleaved 4-wide
//   vectors, so the four read neighbouring shared-memory words) of the
//   scaled query and of the accumulator in registers, and a score is their
//   partial dot products summed by two warp shuffles; K and V are
//   converted to fp32 on load and the online softmax updates once per 16
//   keys.
//
// What bounds it on the H100: for the served model's prefill (bf16, dh 64,
// Lq = Lk = 1,024 to 16,384) the two products, 4 * dh flops per visible
// (query, key) pair, over the tensor cores' 989 TFLOP/s dense bf16 rate;
// the bytes (q, k, v read once, o written once, at 3.35 TB/s) bound it far
// less. What the simple design gives up: mma.sync reaches a fraction of
// what wgmma with TMA-fed, double-buffered tiles and warp specialisation
// would; V is transposed through shared memory by 16-bit stores instead of
// ldmatrix.trans; K/V tiles are loaded by the same warps that compute, with
// no overlap (no cp.async or TMA); the fp32 body reads shared memory once
// per multiply-add and repeats the softmax's exps in the four threads of a
// row.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;                 // queries per block
constexpr int kTpr = 4;                   // threads per query row
constexpr int kThreads = kRows * kTpr;    // 256
constexpr int kKeys = 64;                 // keys per shared-memory tile
constexpr int kChunk = 16;                // keys per online-softmax update
constexpr float kNegInf = -1e30f;

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
             T* __restrict__ o, int lq, int lk, int hq, int hkv, int causal, float scale) {
  constexpr int VEC = DH / kTpr >= 4 ? 4 : DH / kTpr;   // words per vector
  constexpr int NV = DH / (kTpr * VEC);                  // vectors per thread
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);           // [kKeys][DH]
  float* vs = ks + kKeys * DH;                           // [kKeys][DH]

  const int b = blockIdx.y / hq, h = blockIdx.y % hq;
  const int kvh = h / (hq / hkv);
  const int qtile = gridDim.x - 1 - blockIdx.x;          // heaviest causal tiles first
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

// ---- bf16 on the tensor cores (dh >= 16) ---------------------------------
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
                 int lk, int hq, int hkv, int causal, float scale) {
  constexpr int KS = DH + 8;                // K row stride in shared memory
  constexpr int VS = kKeys + 8;             // transposed V row stride
  constexpr int KK = DH / 16;               // k-steps of the first product
  constexpr int ND = DH / 8;                // n-tiles of the second
  __shared__ __align__(16) __nv_bfloat16 ks[kKeys * KS];
  __shared__ __align__(16) __nv_bfloat16 vts[DH * VS];

  const int b = blockIdx.y / hq, h = blockIdx.y % hq;
  const int kvh = h / (hq / hkv);
  const int qtile = gridDim.x - 1 - blockIdx.x;          // heaviest causal tiles first
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

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, void* o, int batch, int lq, int lk,
               int hq, int hkv, int causal, float scale, cudaStream_t stream) {
  const dim3 grid((lq + kRows - 1) / kRows, batch * hq);
  flash_mma_kernel<DH><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lq, lk, hq, hkv,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int lq, int lk,
           int hq, int hkv, int causal, float scale, cudaStream_t stream) {
  const int smem = 2 * kKeys * DH * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lq + kRows - 1) / kRows, batch * hq);
  flash_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lq, lk, hq, hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_fp32(int dh, const void* q, const void* k, const void* v, void* o, int batch,
                int lq, int lk, int hq, int hkv, int causal, float scale, cudaStream_t st) {
  switch (dh) {
    case 8: return launch<float, 8>(q, k, v, o, batch, lq, lk, hq, hkv, causal, scale, st);
    case 16: return launch<float, 16>(q, k, v, o, batch, lq, lk, hq, hkv, causal, scale, st);
    case 32: return launch<float, 32>(q, k, v, o, batch, lq, lk, hq, hkv, causal, scale, st);
    case 64: return launch<float, 64>(q, k, v, o, batch, lq, lk, hq, hkv, causal, scale, st);
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
    case 64: return launch_mma<64>(q, k, v, o, batch, lq, lk, hq, hkv, causal, scale, st);
    case 128: return launch_mma<128>(q, k, v, o, batch, lq, lk, hq, hkv, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Lq, Hq, dh), k and v (B, Lk, Hkv, dh), o like q: contiguous, of one
// dtype (bf16 when is_bf16, else fp32), 16-byte aligned; dh in {8, 16, 32,
// 64, 128}; Hq a multiple of Hkv. Launches on `stream` and returns the CUDA
// error of the launch (cudaGetLastError()), or cudaErrorInvalidValue for a
// dh it was not built for.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int batch, int lq, int lk, int hq, int hkv, int dh,
                                      int is_bf16, int causal, float scale, void* stream) {
  if (batch == 0 || lq == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (is_bf16 ? launch_bf16 : launch_fp32)(dh, q, k, v, o, batch, lq, lk, hq, hkv, causal,
                                               scale, st);
}
