// Mask-spec attention for Hopper (sm_90a): forward (K1) and recompute
// backward (K2).
//
// Replaces the TPU kernels medvill_tpu/ops/flash_attention.py::
// _attn_fwd_kernel (K1, with _visible and _dropout_keep) and
// ::_attn_bwd_kernel (K2).  q, k, v, o and their gradients are read and
// written in the [B, L, heads, 64] layout the Q/K/V projections produce (no
// transposes outside the kernel); the per-sample spec (variant, txt_len) is
// an int32 [B, 2] array, and visibility is computed per element from it, the
// static image block I2 and l_real, as _visible does.  A masked cell gets
// -10000 added to its scaled score, never -inf, so it weighs exactly what
// it weighs on the TPU and in the reference's dense-bias attention.
//
// Design.  The TPU kernel keeps one head's whole [L, L] score matrix in
// VMEM; at L = 436 that is 760 KB of f32, more than an SM's 227 KB of
// shared memory, so K1 is an online-softmax (flash) kernel instead:
//   - grid (ceil(L/64) query tiles, heads, B), 128 threads;
//   - the block's 64 query rows stay in shared memory; it walks the key
//     axis in tiles of 64, K staged transposed and V as is, keeping a
//     running max m and sum l per row and rescaling its O accumulator;
//   - every product is a 64x64x64 tile product on the CUDA cores in f32
//     (mma64 below): each thread owns a 4x8 block of the output, reads a
//     float4 of A (or four broadcast scalars) and two float4 of B per step
//     of the reduction, and does 32 FMAs;
//   - P is dropped before P.V and O is divided by the undropped row sum, as
//     the TPU kernel does; the row log-sum-exp m + log(l) is saved for K2.
// K2 recomputes S and P = exp(S - lse) tile by tile and never stores an
// [L, L] array.  It is three launches, counted as one K2 call:
//   1. attn_bwd_dot: Dvec[r] = rowsum(dO * O) in f32, which equals
//      rowsum(P * dP) with or without dropout;
//   2. attn_bwd_dkdv: grid over key tiles, loop over query tiles:
//      dV += P_drop^T dO, dK += dS^T Q * scale with dS = P * (dP - Dvec);
//   3. attn_bwd_dq: grid over query tiles, loop over key tiles:
//      dQ += dS K * scale.
// No atomics: every output element is written by one thread, so the
// backward is deterministic.
//
// Bound at the pretrain shape (B = 36, L = 436, 12 x 64, bf16): K1 moves
// q, k, v, o = 96 MB (28.8 us at 3.35 TB/s) and does 21 GFLOP; on the f32
// CUDA cores (67 TFLOP/s) that is 314 us, on the bf16 tensor cores 21 us.
// This first version runs on the CUDA cores, so it is bound by operations;
// tensor cores (mma.sync / wgmma) are a later change.
//
// Dropout keep mask: a pure function of (seed, b, head, r, c), kept iff
// fmix32(seed ^ (((b * heads + head) * L + r) * L + c)) >= floor(rate*2^32)
// in uint32 arithmetic.  medvill_torch/ops/flash_attention.py::keep_mask
// computes the same bits, so forward, backward and the plain version agree
// bit for bit; none of them gives the TPU PRNG's bits.
//
// C interface for ctypes: pointers and the stream as void*, each entry point
// returns cudaGetLastError() after its launches.  Allocates nothing; runs on
// `stream`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;                  // head dim
constexpr int kTile = 64;               // query and key rows per tile
constexpr int kS = kD + 4;              // padded shared row, float4-aligned
constexpr int kTileFloats = kTile * kS;
constexpr int kThreads = 128;
constexpr float kNeg = -10000.f;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

struct Spec {
  int family, variant, txt_len, img_block, l_real;

  __device__ __forceinline__ bool visible(int r, int c) const {
    const int I2 = img_block;
    bool vis;
    if (family == 0) {  // pretrain: FULL/S2S/BAR/NONCROSS/ATTN1D
      const bool full = (c < I2) || (c - I2 < txt_len);
      const bool s2s = (c < I2) || (r >= I2 && c >= I2 && c <= r);
      const bool bar = s2s || (r < I2);
      const bool nc = (r < I2 && c < I2) || (r >= I2 && c >= I2);
      vis = variant == 1 ? s2s : variant == 2 ? bar : variant == 3 ? nc : full;
    } else {  // seq2seq: 0 bi, 1 s2s, 2 bar; txt_len carries n_tokens
      const int n = txt_len;
      const bool bi = c < n;
      const bool causal = r >= I2 && r < n && c >= I2 && c <= r;
      const bool s2s = (c < I2) || causal;
      const bool bar = s2s || (r < I2);
      vis = variant == 1 ? s2s : variant == 2 ? bar : bi;
    }
    return vis && c < l_real;
  }
};

struct Dropout {
  int on;
  uint32_t seed, thresh;
  float scale;
  uint32_t base;  // (b * heads + head) * L
  uint32_t L;

  __device__ __forceinline__ bool keep(int r, int c) const {
    const uint32_t idx = (base + static_cast<uint32_t>(r)) * L + static_cast<uint32_t>(c);
    return fmix32(seed ^ idx) >= thresh;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16 bytes of T, unpacked to f32.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  using Raw = float4;
  __device__ static void unpack(const Raw& r, float* v) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  __device__ static void unpack(const Raw& r, float* v) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

// Four consecutive output values of one row, stored as T.
__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* v) {
  uint2 r;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&r);
  p[0] = __floats2bfloat162_rn(v[0], v[1]);
  p[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(dst) = r;
}

// Global row r of head h of batch element b in the [B, L, heads, 64] layout.
template <typename T>
__device__ __forceinline__ const T* row_ptr(const T* base, int b, int r, int L, int heads,
                                            int h) {
  return base + ((static_cast<size_t>(b) * L + r) * heads + h) * kD;
}

// Rows [row0, row0 + 64) of one head into shared memory as f32, natural
// layout dst[r][d]; rows at or past L are zero.  Neighbouring threads read
// neighbouring 16-byte chunks of a row.
template <typename T>
__device__ void load_tile(float* dst, const T* src, int b, int row0, int L, int heads, int h) {
  using V = Vec16<T>;
  constexpr int N = V::N;
  constexpr int kChunks = kD / N;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, ch = i % kChunks;
    float v[N];
    if (row0 + r < L) {
      V::unpack(reinterpret_cast<const typename V::Raw*>(row_ptr(src, b, row0 + r, L, heads, h))[ch], v);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; e += 4) store4(dst + r * kS + ch * N + e, v + e);
  }
}

// The same rows transposed, dst[d][r].  Neighbouring threads take
// neighbouring rows, so the shared-memory stores do not conflict.
template <typename T>
__device__ void load_tile_t(float* dst, const T* src, int b, int row0, int L, int heads, int h) {
  using V = Vec16<T>;
  constexpr int N = V::N;
  constexpr int kChunks = kD / N;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i % kTile, ch = i / kTile;
    float v[N];
    if (row0 + r < L) {
      V::unpack(reinterpret_cast<const typename V::Raw*>(row_ptr(src, b, row0 + r, L, heads, h))[ch], v);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) dst[(ch * N + e) * kS + r] = v[e];
  }
}

// Column of a thread's j-th output: n0 + (j & 3) + 32 * (j >> 2), n0 = 4 *
// (tid & 7).  Two float4 per row, 32 apart, so the eight threads of a
// quarter warp read eight distinct float4 of B without a bank conflict.
__device__ __forceinline__ int col_of(int n0, int j) { return n0 + (j & 3) + ((j >> 2) << 5); }

// acc[i][j] += sum_k A(k, m0 + i) * B[k][col_of(n0, j)] over k < 64.
// A_KMAJOR: A is stored [k][m] (one float4); else [m][k] (four scalars, the
// same address for the eight threads that share m0: a broadcast).
template <bool A_KMAJOR>
__device__ __forceinline__ void mma64(float (&acc)[4][8], const float* A, const float* B, int m0,
                                      int n0) {
#pragma unroll 4
  for (int k = 0; k < kD; ++k) {
    float a[4];
    if (A_KMAJOR) {
      const float4 t = *reinterpret_cast<const float4*>(A + k * kS + m0);
      a[0] = t.x; a[1] = t.y; a[2] = t.z; a[3] = t.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[(m0 + i) * kS + k];
    }
    const float4 b0 = *reinterpret_cast<const float4*>(B + k * kS + n0);
    const float4 b1 = *reinterpret_cast<const float4*>(B + k * kS + n0 + 32);
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void store_row8(float* dst, const float (&v)[8]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 32) = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename T>
__device__ __forceinline__ void store_out_row(T* base, int b, int r, int L, int heads, int h,
                                              int n0, const float (&v)[8]) {
  T* dst = base + ((static_cast<size_t>(b) * L + r) * heads + h) * kD + n0;
  store4(dst, v);
  store4(dst + 32, v + 4);
}

__device__ __forceinline__ void zero(float (&a)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) a[i][j] = 0.f;
}

struct Args {
  int L, heads, img_block, l_real, family, dropout;
  uint32_t seed, thresh;
  float drop_scale, scale;
};

__device__ __forceinline__ Spec make_spec(const int* spec, int b, const Args& a) {
  return Spec{a.family, spec[2 * b], spec[2 * b + 1], a.img_block, a.l_real};
}

__device__ __forceinline__ Dropout make_dropout(int b, int h, const Args& a) {
  return Dropout{a.dropout, a.seed, a.thresh, a.drop_scale,
                 (static_cast<uint32_t>(b) * a.heads + h) * static_cast<uint32_t>(a.L),
                 static_cast<uint32_t>(a.L)};
}

// ---------------------------------------------------------------- K1 ----
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const int* __restrict__ spec, T* __restrict__ o, float* __restrict__ lse,
                Args a) {
  extern __shared__ float smem[];
  float* Qs = smem;                // [r][d]
  float* KP = Qs + kTileFloats;    // K^T [d][c], then P [r][c]
  float* Vs = KP + kTileFloats;    // [c][d]
  const int h = blockIdx.y, b = blockIdx.z, L = a.L;
  const int r0 = blockIdx.x * kTile;
  const int m0 = (threadIdx.x >> 3) * 4, n0 = (threadIdx.x & 7) * 4;
  const Spec sp = make_spec(spec, b, a);
  const Dropout dr = make_dropout(b, h, a);

  load_tile(Qs, q, b, r0, L, a.heads, h);
  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.f; }
  zero(acc);

  for (int c0 = 0; c0 < L; c0 += kTile) {
    __syncthreads();  // the previous tile's P and V are no longer read
    load_tile_t(KP, k, b, c0, L, a.heads, h);
    load_tile(Vs, v, b, c0, L, a.heads, h);
    __syncthreads();
    float s[4][8];
    zero(s);
    mma64<false>(s, Qs, KP, m0, n0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + m0 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + col_of(n0, j);
        s[i][j] = c < L ? s[i][j] * a.scale + (sp.visible(r, c) ? 0.f : kNeg) : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);  // finite: column c0 < L is in range
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;  // the undropped row sum
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
      if (dr.on) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[i][j] = dr.keep(r, c0 + col_of(n0, j)) ? s[i][j] * dr.scale : 0.f;
      }
    }
    __syncthreads();  // every thread is done reading K^T
#pragma unroll
    for (int i = 0; i < 4; ++i) store_row8(KP + (m0 + i) * kS + n0, s[i]);
    __syncthreads();
    mma64<false>(acc, KP, Vs, m0, n0);  // O += P V
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + m0 + i;
    if (r >= L) continue;
    const float inv = 1.f / l[i];
    float out[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = acc[i][j] * inv;
    store_out_row(o, b, r, L, a.heads, h, n0, out);
    if (n0 == 0) lse[(static_cast<size_t>(b) * a.heads + h) * L + r] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------- K2 ----
// Dvec[b, h, r] = sum_d dO * O, one warp per (b, r, h) row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ dvec, int rows, int L, int heads) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const size_t base = static_cast<size_t>(row) * kD + lane * 2;
  float acc;
  if (sizeof(T) == 4) {
    const float2 x = *reinterpret_cast<const float2*>(reinterpret_cast<const float*>(o) + base);
    const float2 y = *reinterpret_cast<const float2*>(reinterpret_cast<const float*>(dout) + base);
    acc = x.x * y.x + x.y * y.y;
  } else {
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(reinterpret_cast<const __nv_bfloat16*>(o) + base));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        reinterpret_cast<const __nv_bfloat16*>(dout) + base));
    acc = x.x * y.x + x.y * y.y;
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    const int b = row / (L * heads), rem = row % (L * heads);
    dvec[(static_cast<size_t>(b) * heads + rem % heads) * L + rem / heads] = acc;
  }
}

// dK and dV for one key tile, looping over the query tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ dvec, const int* __restrict__ spec,
                     T* __restrict__ dk, T* __restrict__ dv, Args a) {
  extern __shared__ float smem[];
  float* Kt = smem;                 // K^T [d][c]
  float* Vt = Kt + kTileFloats;     // V^T [d][c]
  float* Qs = Vt + kTileFloats;     // [r][d]
  float* dOs = Qs + kTileFloats;    // [r][d]
  float* Buf = dOs + kTileFloats;   // P_drop, then dS, as [r][c]
  float* lse_s = Buf + kTileFloats;
  float* dvec_s = lse_s + kTile;
  const int h = blockIdx.y, b = blockIdx.z, L = a.L;
  const int c0 = blockIdx.x * kTile;
  const int m0 = (threadIdx.x >> 3) * 4, n0 = (threadIdx.x & 7) * 4;
  const Spec sp = make_spec(spec, b, a);
  const Dropout dr = make_dropout(b, h, a);
  const size_t row_base = (static_cast<size_t>(b) * a.heads + h) * L;

  load_tile_t(Kt, k, b, c0, L, a.heads, h);
  load_tile_t(Vt, v, b, c0, L, a.heads, h);
  float acc_dk[4][8], acc_dv[4][8];
  zero(acc_dk);
  zero(acc_dv);

  for (int r0 = 0; r0 < L; r0 += kTile) {
    __syncthreads();  // the previous tile's Q, dO and Buf are no longer read
    load_tile(Qs, q, b, r0, L, a.heads, h);
    load_tile(dOs, dout, b, r0, L, a.heads, h);
    if (threadIdx.x < kTile) {
      const int r = r0 + threadIdx.x;
      lse_s[threadIdx.x] = r < L ? lse[row_base + r] : 0.f;
      dvec_s[threadIdx.x] = r < L ? dvec[row_base + r] : 0.f;
    }
    __syncthreads();
    float p[4][8], dp[4][8];
    zero(p);
    zero(dp);
    mma64<false>(p, Qs, Kt, m0, n0);    // S [r][c]
    mma64<false>(dp, dOs, Vt, m0, n0);  // dO V^T [r][c]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + m0 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + col_of(n0, j);
        float pij = 0.f, dsij = 0.f;
        if (r < L && c < L) {
          pij = expf(p[i][j] * a.scale + (sp.visible(r, c) ? 0.f : kNeg) - lse_s[m0 + i]);
          float dpij = dp[i][j];
          float pd = pij;
          if (dr.on) {
            const bool kp = dr.keep(r, c);
            dpij = kp ? dpij * dr.scale : 0.f;
            pd = kp ? pij * dr.scale : 0.f;
          }
          dsij = pij * (dpij - dvec_s[m0 + i]);
          pij = pd;
        }
        p[i][j] = pij;   // P_drop
        dp[i][j] = dsij; // dS
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) store_row8(Buf + (m0 + i) * kS + n0, p[i]);
    __syncthreads();
    mma64<true>(acc_dv, Buf, dOs, m0, n0);  // dV[c][d] += P_drop[r][c] dO[r][d]
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) store_row8(Buf + (m0 + i) * kS + n0, dp[i]);
    __syncthreads();
    mma64<true>(acc_dk, Buf, Qs, m0, n0);   // dK[c][d] += dS[r][c] Q[r][d]
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + m0 + i;
    if (c >= L) continue;
    float out[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = acc_dk[i][j] * a.scale;
    store_out_row(dk, b, c, L, a.heads, h, n0, out);
    store_out_row(dv, b, c, L, a.heads, h, n0, acc_dv[i]);
  }
}

// dQ for one query tile, looping over the key tiles.  Works on S^T so that
// K and V are staged as they are and only Q and dO, fixed per block, are
// transposed.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ dvec, const int* __restrict__ spec,
                   T* __restrict__ dq, Args a) {
  extern __shared__ float smem[];
  float* Qt = smem;                 // Q^T [d][r]
  float* dOt = Qt + kTileFloats;    // dO^T [d][r]
  float* Ks = dOt + kTileFloats;    // [c][d]
  float* Vs = Ks + kTileFloats;     // [c][d]
  float* Buf = Vs + kTileFloats;    // dS^T [c][r]
  const int h = blockIdx.y, b = blockIdx.z, L = a.L;
  const int r0 = blockIdx.x * kTile;
  const int m0 = (threadIdx.x >> 3) * 4, n0 = (threadIdx.x & 7) * 4;
  const Spec sp = make_spec(spec, b, a);
  const Dropout dr = make_dropout(b, h, a);
  const size_t row_base = (static_cast<size_t>(b) * a.heads + h) * L;

  load_tile_t(Qt, q, b, r0, L, a.heads, h);
  load_tile_t(dOt, dout, b, r0, L, a.heads, h);
  float lse_r[8], dvec_r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int r = r0 + col_of(n0, j);
    lse_r[j] = r < L ? lse[row_base + r] : 0.f;
    dvec_r[j] = r < L ? dvec[row_base + r] : 0.f;
  }
  float acc[4][8];
  zero(acc);

  for (int c0 = 0; c0 < L; c0 += kTile) {
    __syncthreads();  // the previous tile's K, V and Buf are no longer read
    load_tile(Ks, k, b, c0, L, a.heads, h);
    load_tile(Vs, v, b, c0, L, a.heads, h);
    __syncthreads();
    float st[4][8], dpt[4][8];
    zero(st);
    zero(dpt);
    mma64<false>(st, Ks, Qt, m0, n0);    // S^T [c][r]
    mma64<false>(dpt, Vs, dOt, m0, n0);  // (dO V^T)^T [c][r]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + m0 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = r0 + col_of(n0, j);
        float dsij = 0.f;
        if (r < L && c < L) {
          const float pij =
              expf(st[i][j] * a.scale + (sp.visible(r, c) ? 0.f : kNeg) - lse_r[j]);
          float dpij = dpt[i][j];
          if (dr.on) dpij = dr.keep(r, c) ? dpij * dr.scale : 0.f;
          dsij = pij * (dpij - dvec_r[j]);
        }
        st[i][j] = dsij;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) store_row8(Buf + (m0 + i) * kS + n0, st[i]);
    __syncthreads();
    mma64<true>(acc, Buf, Ks, m0, n0);  // dQ[r][d] += dS^T[c][r] K[c][d]
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + m0 + i;
    if (r >= L) continue;
    float out[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = acc[i][j] * a.scale;
    store_out_row(dq, b, r, L, a.heads, h, n0, out);
  }
}

constexpr size_t kFwdSmem = 3 * kTileFloats * sizeof(float);
constexpr size_t kDkdvSmem = (5 * kTileFloats + 2 * kTile) * sizeof(float);
constexpr size_t kDqSmem = 5 * kTileFloats * sizeof(float);

// Lifts a kernel's dynamic shared-memory limit above 48 KB, once per
// kernel, before the first launch (so never inside a CUDA graph capture).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  done = err == cudaSuccess;
  return err;
}

Args make_args(int L, int heads, int img_block, int l_real, int family, int dropout,
               unsigned seed, unsigned thresh, float drop_scale, float scale) {
  return Args{L, heads, img_block, l_real, family, dropout, seed, thresh, drop_scale, scale};
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, const int* spec, void* o, float* lse, int B,
        const Args& a, cudaStream_t s) {
  static bool smem_set = false;
  cudaError_t err = allow_smem(attn_fwd_kernel<T>, kFwdSmem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.L + kTile - 1) / kTile, a.heads, B);
  attn_fwd_kernel<T><<<grid, kThreads, kFwdSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), spec,
      static_cast<T*>(o), lse, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
        const float* lse, const int* spec, void* dq, void* dk, void* dv, float* dvec, int B,
        const Args& a, cudaStream_t s) {
  const int rows = B * a.L * a.heads;
  attn_bwd_dot_kernel<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), dvec, rows, a.L, a.heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.L + kTile - 1) / kTile, a.heads, B);
  static bool dkdv_set = false, dq_set = false;
  err = allow_smem(attn_bwd_dkdv_kernel<T>, kDkdvSmem, dkdv_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_kernel<T><<<grid, kThreads, kDkdvSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, dvec, spec, static_cast<T*>(dk), static_cast<T*>(dv), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(attn_bwd_dq_kernel<T>, kDqSmem, dq_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_kernel<T><<<grid, kThreads, kDqSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, dvec, spec, static_cast<T*>(dq), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: [B, L, heads, 64] of f32 (is_bf16 = 0) or bf16, contiguous and
// 16-byte aligned; spec: int32 [B, 2]; lse: f32 [B, heads, L].  The Python
// wrapper checks every shape and type.
extern "C" int medvill_attn_fwd(const void* q, const void* k, const void* v, const int* spec,
                                void* o, float* lse, int B, int L, int heads, int is_bf16,
                                int img_block, int l_real, int family, int dropout,
                                unsigned int seed, unsigned int thresh, float drop_scale,
                                float scale, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  const Args a = make_args(L, heads, img_block, l_real, family, dropout, seed, thresh,
                           drop_scale, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? fwd<__nv_bfloat16>(q, k, v, spec, o, lse, B, a, s)
                 : fwd<float>(q, k, v, spec, o, lse, B, a, s);
}

// dout, dq, dk, dv: as q; dvec: f32 scratch [B, heads, L].
extern "C" int medvill_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const float* lse, const int* spec, void* dq,
                                void* dk, void* dv, float* dvec, int B, int L, int heads,
                                int is_bf16, int img_block, int l_real, int family, int dropout,
                                unsigned int seed, unsigned int thresh, float drop_scale,
                                float scale, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  const Args a = make_args(L, heads, img_block, l_real, family, dropout, seed, thresh,
                           drop_scale, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bwd<__nv_bfloat16>(q, k, v, o, dout, lse, spec, dq, dk, dv, dvec, B, a, s)
                 : bwd<float>(q, k, v, o, dout, lse, spec, dq, dk, dv, dvec, B, a, s);
}
