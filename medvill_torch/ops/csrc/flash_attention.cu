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
// Shape of both.  The TPU kernel keeps one head's whole [L, L] score matrix
// in VMEM; at L = 436 that is 760 KB of f32, more than an SM's 227 KB of
// shared memory, so K1 is an online-softmax (flash) kernel: a block owns 64
// query rows of one head and walks the key axis in tiles of 64, keeping a
// running max m and sum l per row and rescaling its O accumulator.  P is
// dropped before P.V and O is divided by the undropped row sum, as the TPU
// kernel does; the row log-sum-exp m + log(l) is saved for K2.  K2
// recomputes S and P = exp(S - lse) tile by tile and never stores an [L, L]
// array.  It is three launches, counted as one K2 call:
//   1. attn_bwd_dot: Dvec[r] = rowsum(dO * O) in f32, which equals
//      rowsum(P * dP) with or without dropout;
//   2. dK/dV: grid over key tiles, loop over query tiles:
//      dV += P_drop^T dO, dK += dS^T Q * scale with dS = P * (dP - Dvec);
//   3. dQ: grid over query tiles, loop over key tiles: dQ += dS K * scale.
// No atomics: every output element is written by one thread, so the
// backward is deterministic.
//
// Two instantiations of that shape:
//
// bf16 (the training path): tensor-core tile products.  Every product is
// mma.sync.m16n8k16 with bf16 operands and f32 accumulation; each of a
// block's 4 warps owns 16 rows of the 64-row tile.  Q/K/V/dO tiles are
// staged in shared memory as bf16 in rows padded to 72 values (144 bytes,
// so the eight rows one ldmatrix reads start in eight distinct 16-byte bank
// groups), loaded with cp.async into two stages so the next key (or query)
// tile is in flight while the current one is in the tensor cores.  ldmatrix
// (.trans where the operand is the tile's transpose) builds every B
// fragment; no tile is transposed by scalar stores.  S and dP accumulate in
// f32 from bf16 inputs, so they are exact up to f32 summation.  P (after
// dropout; K2 also scales it by 1 / (1 - rate), which K1 applies to O at
// the end) and dS are rounded to bf16 only as the A operand of the next
// product, straight from the accumulator registers (the m16n8 accumulator
// layout of two neighbouring n-tiles is the m16k16 A layout), with no trip
// through shared memory.  The key-tile kernel computes S^T = K Q^T and
// dP^T = V dO^T, so P_drop^T and dS^T are already A operands of dV +=
// P_drop^T dO and dK += dS^T Q.  Scores are kept in log2 units (exp2f); lse
// is written in natural units.  Each row's visible columns are one interval
// (Spec::cols), so a cell's mask is one unsigned compare, and K1 skips even
// that where a thread's rows see the whole tile.  Per cell, the mask test,
// exp2 and the keep-mask hash on the CUDA cores cost more than the tensor
// cores' share, so the kernels are tuned for resident warps: K1 keeps 128
// registers and 45 KB of shared memory (4 blocks per SM); the K2 kernels
// build S^T/dP^T (S/dP) 16 columns at a time and turn each slice into A
// fragments at once (dK/dV also takes the slice's share of its two
// products at once), so only 16 score accumulators are live, and the dQ
// kernel keeps its rows' lse, Dvec and column interval in shared memory:
// both fit 4 blocks per SM (128 registers), without spills.
//
// f32 (not on the training path; the f32 parity runs and card tests): the
// first version's CUDA-core code, kept as it was, because the bf16 tensor
// cores cannot compute an f32 product to f32 accuracy.  Each product is a
// 64x64x64 f32 FMA loop (mma64); tiles are staged as f32, K/Q/dO
// transposed on load; no tile is skipped.
//
// Skipping masked tile pairs (bf16).  A (query tile, key tile) pair whose
// every cell the spec masks is never loaded or multiplied: Spec::skip is a
// closed form on (family, variant, txt_len, I2, l_real) and the two tiles'
// row and column ranges (twin: medvill_torch/data/masks.py::
// tile_skippable).  At BAR, L = 436, I2 = 182 these are the 6 of 49 pairs
// above the causal text diagonal.  This is exact: skip requires that every
// row of the query tile has a visible column (column 0 for every variant
// but NONCROSS text rows, which see column I2), and then a masked cell's
// weight exp(s - 10000 - m) is exactly 0 in f32 while every scaled score
// has |s| < 4948: the row max m is at least a visible score > -4948, so
// the exponent is under 2 * 4948 - 10000 = -104 (e^-104 < 2^-150, past
// f32's smallest subnormal 2^-149).  In the forward's running sum such a
// weight adds 0, or is zeroed by the alpha = exp(m_old - m_new) = 0 that
// the first visible tile applies (tile 0 always holds one); in the
// backward P = exp(S - lse) = 0, so P_drop = dS = 0.  Skipping it then
// changes no bit of l, O, lse, dQ, dK or dV.  Scores past that bound (a
// diverging run) void the argument, and nothing checks for them.  Which
// pairs the kernels skip is read back on the card
// (flash_attention.py::skipped_tiles) and held against the twin.
//
// Bound at the pretrain shape (B = 36, L = 436, 12 x 64, bf16): K1 moves
// q, k, v, o = 96 MB (28.8 us at 3.35 TB/s) and does 21 GFLOP (21 us on
// the bf16 tensor cores); K2 moves 8 such tensors (57.6 us) and does 53
// GFLOP of the 5 products the algorithm needs (53 us); this K2 does 7 (S
// and dP once per output side), the price of one writer per output.
//
// Dropout keep mask: a pure function of (seed, b, head, r, c), kept iff
// fmix32(seed ^ (((b * heads + head) * L + r) * L + c)) >= floor(rate*2^32)
// in uint32 arithmetic.  medvill_torch/ops/flash_attention.py::keep_mask
// computes the same bits, so forward, backward and the plain version agree
// bit for bit; none of them gives the TPU PRNG's bits.  The seed is the
// launch's uint32 plus, where seed_ptr is not null, the uint32 at seed_ptr
// in device memory (the JAX kernels' seed_ref): a CUDA graph that captured
// the launch reads the word anew at every replay, so each replay draws the
// mask of the seed the host wrote there before it.
//
// C interface for ctypes: pointers and the stream as void*, each entry point
// returns cudaGetLastError() after its launches.  Allocates nothing; runs on
// `stream`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;                  // head dim
constexpr int kTile = 64;               // query and key rows per tile
constexpr int kS = kD + 4;              // padded f32 shared row, float4-aligned
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

  // visible(r, c) as one interval of columns per row: every variant's
  // visible set in row r is [lo, hi) (then cut at l_real), so the bf16
  // kernels test a cell with one unsigned compare, (c - lo) < (hi - lo).
  // The branches are uniform: family and variant are the block's.
  __device__ __forceinline__ void cols(int r, int& lo, int& hi) const {
    constexpr int kAll = 1 << 30;
    const int I2 = img_block;
    lo = 0;
    if (family == 0) {
      if (variant == 1) hi = r >= I2 ? r + 1 : I2;              // S2S
      else if (variant == 2) hi = r >= I2 ? r + 1 : kAll;       // BAR
      else if (variant == 3) {                                   // NONCROSS
        lo = r < I2 ? 0 : I2;
        hi = r < I2 ? I2 : kAll;
      } else hi = max(I2, I2 + txt_len);                         // FULL, ATTN1D
    } else {
      const int n = txt_len;
      const bool causal = r >= I2 && r < n;
      if (variant == 1) hi = causal ? r + 1 : I2;                // s2s
      else if (variant == 2) hi = r < I2 ? kAll : causal ? r + 1 : I2;  // bar
      else hi = n;                                               // bi
    }
    hi = min(hi, l_real);
    hi = max(hi, lo);
  }

  // Whether visible(r, c) holds for some r in [r_lo, r_hi], c in [c_lo,
  // c_hi] (inclusive, all < L): each region of visible() is a rectangle or
  // the triangle c <= r, tested in closed form.
  __device__ __forceinline__ bool any_visible(int r_lo, int r_hi, int c_lo, int c_hi) const {
    const int I2 = img_block;
    c_hi = min(c_hi, l_real - 1);
    if (c_hi < c_lo) return false;
    const bool img_cols = c_lo < I2, img_rows = r_lo < I2;
    const int cc = max(c_lo, I2);
    if (family == 0) {
      if (variant == 3) return (img_rows && img_cols) || (r_hi >= I2 && c_hi >= I2);
      if (variant == 1 || variant == 2) {
        const bool causal = r_hi >= I2 && cc <= c_hi && cc <= r_hi;
        return img_cols || causal || (variant == 2 && img_rows);
      }
      return c_lo < max(I2, I2 + txt_len);
    }
    const int n = txt_len;
    if (variant == 1 || variant == 2) {
      const int rr_lo = max(r_lo, I2), rr_hi = min(r_hi, n - 1);
      const bool causal = rr_lo <= rr_hi && cc <= c_hi && cc <= rr_hi;
      return img_cols || causal || (variant == 2 && img_rows);
    }
    return c_lo < n;
  }

  // Whether every row in [r_lo, r_hi] has a visible column (< L).
  __device__ __forceinline__ bool rows_see_a_column(int r_hi, int L) const {
    const int I2 = img_block, lr = min(l_real, L);
    if (lr < 1) return false;
    if (family == 0) return variant == 3 ? (r_hi < I2 || lr > I2) : I2 >= 1;
    return (variant == 1 || variant == 2) ? I2 >= 1 : txt_len >= 1;
  }

  // The (query tile at r0, key tile at c0) pair is masked in every cell
  // and may be skipped (see the header).
  __device__ __forceinline__ bool skip(int r0, int c0, int L) const {
    const int r_hi = min(r0 + kTile, L) - 1, c_hi = min(c0 + kTile, L) - 1;
    return rows_see_a_column(r_hi, L) && !any_visible(r0, r_hi, c0, c_hi);
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

// Global row r of head h of batch element b in the [B, L, heads, 64] layout.
template <typename T>
__device__ __forceinline__ const T* row_ptr(const T* base, int b, int r, int L, int heads,
                                            int h) {
  return base + ((static_cast<size_t>(b) * L + r) * heads + h) * kD;
}

struct Args {
  int L, heads, img_block, l_real, family, dropout;
  const uint32_t* seed_ptr;
  uint32_t seed, thresh;
  float drop_scale, scale;
  // made on the host, so that no register holds them (the device seed
  // takes one where the launch's seed took none)
  float scale_log2e;  // scale * log2(e)
  int n_tiles;        // ceil(L / kTile)
};

__device__ __forceinline__ Spec make_spec(const int* spec, int b, const Args& a) {
  return Spec{a.family, spec[2 * b], spec[2 * b + 1], a.img_block, a.l_real};
}

__device__ __forceinline__ Dropout make_dropout(int b, int h, const Args& a) {
  const uint32_t seed = (a.dropout && a.seed_ptr) ? a.seed + __ldg(a.seed_ptr) : a.seed;
  return Dropout{a.dropout, seed, a.thresh, a.drop_scale,
                 (static_cast<uint32_t>(b) * a.heads + h) * static_cast<uint32_t>(a.L),
                 static_cast<uint32_t>(a.L)};
}

// ============================================ f32: CUDA-core tile products

// Rows [row0, row0 + 64) of one head into shared memory, natural layout
// dst[r][d]; rows at or past L are zero.  Neighbouring threads read
// neighbouring 16-byte chunks of a row.
__device__ void load_tile(float* dst, const float* src, int b, int row0, int L, int heads, int h) {
  constexpr int kChunks = kD / 4;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, ch = i % kChunks;
    const float4 v = row0 + r < L
        ? reinterpret_cast<const float4*>(row_ptr(src, b, row0 + r, L, heads, h))[ch]
        : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * kS + ch * 4) = v;
  }
}

// The same rows transposed, dst[d][r].  Neighbouring threads take
// neighbouring rows, so the shared-memory stores do not conflict.
__device__ void load_tile_t(float* dst, const float* src, int b, int row0, int L, int heads,
                            int h) {
  constexpr int kChunks = kD / 4;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i % kTile, ch = i / kTile;
    const float4 v = row0 + r < L
        ? reinterpret_cast<const float4*>(row_ptr(src, b, row0 + r, L, heads, h))[ch]
        : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[(ch * 4 + 0) * kS + r] = v.x;
    dst[(ch * 4 + 1) * kS + r] = v.y;
    dst[(ch * 4 + 2) * kS + r] = v.z;
    dst[(ch * 4 + 3) * kS + r] = v.w;
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

__device__ __forceinline__ void store_out_row(float* base, int b, int r, int L, int heads, int h,
                                              int n0, const float (&v)[8]) {
  float* dst = base + ((static_cast<size_t>(b) * L + r) * heads + h) * kD + n0;
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 32) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void zero(float (&a)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) a[i][j] = 0.f;
}

// K1, f32.
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ spec, float* __restrict__ o,
                float* __restrict__ lse, Args a) {
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

// K2 (both types), step 1: Dvec[b, h, r] = sum_d dO * O, one (b, r, h)
// row per 8 (bf16) or 16 (f32) threads, 16 bytes of each operand a thread.
__device__ __forceinline__ float dot16(const uint4& x, const uint4& y, float) {
  const float4 a = *reinterpret_cast<const float4*>(&x), b = *reinterpret_cast<const float4*>(&y);
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ float dot16(const uint4& x, const uint4& y, bf16) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(a[i]), fb = __bfloat1622float2(b[i]);
    acc += fa.x * fb.x + fa.y * fb.y;
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ dvec, int rows, int L, int heads) {
  constexpr int kLanes = kD * sizeof(T) / 16;  // threads per row
  const int row = blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  float acc = 0.f;
  if (row < rows) {
    const size_t base = static_cast<size_t>(row) * kD;
    acc = dot16(reinterpret_cast<const uint4*>(o + base)[lane],
                reinterpret_cast<const uint4*>(dout + base)[lane], T());
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && lane == 0) {
    const int b = row / (L * heads), rem = row % (L * heads);
    dvec[(static_cast<size_t>(b) * heads + rem % heads) * L + rem / heads] = acc;
  }
}

// K2, f32: dK and dV for one key tile, looping over the query tiles.
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dvec,
                     const int* __restrict__ spec, float* __restrict__ dk, float* __restrict__ dv,
                     Args a) {
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
  const size_t row_base = dr.base;  // (b * heads + h) * L

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

// K2, f32: dQ for one query tile, looping over the key tiles.  Works on
// S^T so that K and V are staged as they are and only Q and dO, fixed per
// block, are transposed.
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ dvec,
                   const int* __restrict__ spec, float* __restrict__ dq, Args a) {
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
  const size_t row_base = dr.base;  // (b * heads + h) * L

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

// ======================================== bf16: tensor-core tile products

constexpr int kLd = kD + 8;              // bf16 per shared row (144 bytes)
constexpr int kTileH = kTile * kLd;      // bf16 per staged tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment addressing, lane = threadIdx.x & 31, for a tile of 64 rows of
// kLd bf16.  A: the 16x16 block at rows m0, columns 16 kk, row-major.
__device__ __forceinline__ const bf16* a_addr(const bf16* t, int m0, int kk, int lane) {
  return t + (m0 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8;
}
// B of n-tiles nt, nt + 1 (8 rows each) and k columns 16 kk, from a tile
// stored [n][k]: regs {b0, b1} of nt, then of nt + 1.
__device__ __forceinline__ const bf16* b_addr(const bf16* t, int nt, int kk, int lane) {
  return t + ((nt + (lane >> 4)) * 8 + (lane & 7)) * kLd + kk * 16 + ((lane >> 3) & 1) * 8;
}
// The same from a tile stored [k][n] (with ldsm_x4_t).
__device__ __forceinline__ const bf16* bt_addr(const bf16* t, int nt, int kk, int lane) {
  return t + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + (nt + (lane >> 4)) * 8;
}

// The A fragment (k = the 16 columns of n-tiles 2 kk, 2 kk + 1) of c.
__device__ __forceinline__ void pair_to_a(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

// acc[n-tile][4] (m16n8 accumulators of 16 rows x 64 columns) as the A
// fragments of the next product over those 64 columns, rounded to bf16.
// Element e of n-tile nt of warp w's accumulators sits at row w*16 + g +
// 8 (e >> 1) and column nt*8 + 2 tq + (e & 1), g = lane / 4, tq = lane % 4.
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&acc)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    pair_to_a(a[kk], *reinterpret_cast<const float(*)[2][4]>(&acc[2 * kk]));
}

__device__ __forceinline__ void zero(float (&a)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
}

// acc += A (16 x 16, fragment a: columns 16 kk of a 16 x 64 A) * B (rows
// 16 kk of a 64 x 64 tile read with ldmatrix; TRANS: stored [k][n]; else
// stored [n][k]).
template <bool TRANS>
__device__ __forceinline__ void mma_k16(float (&acc)[8][4], const uint32_t (&a)[4],
                                        const bf16* t, int kk, int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; nt += 2) {
    uint32_t bb[4];
    if (TRANS) ldsm_x4_t(bb, bt_addr(t, nt, kk, lane));
    else ldsm_x4(bb, b_addr(t, nt, kk, lane));
    mma16816(acc[nt], a, bb[0], bb[1]);
    mma16816(acc[nt + 1], a, bb[2], bb[3]);
  }
}

// acc += A (16 x 64, fragments a) * B, B's whole 64 x 64 tile.
template <bool TRANS>
__device__ __forceinline__ void mma_row(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                        const bf16* t, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_k16<TRANS>(acc, a[kk], t, kk, lane);
}

__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* t, int m0, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[kk], a_addr(t, m0, kk, lane));
}

// c[t] += the n-tile nt + t (t = 0, 1) of A B^T, A the 16 x 64 block at
// rows m0 of ta, B stored [n][k] in tb; A's fragments are read again for
// each pair of n-tiles, so only 16 accumulators are live at a time.
__device__ __forceinline__ void mma_pair(float (&c)[2][4], const bf16* ta, int m0,
                                         const bf16* tb, int nt, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4], bb[4];
    ldsm_x4(a, a_addr(ta, m0, kk, lane));
    ldsm_x4(bb, b_addr(tb, nt, kk, lane));
    mma16816(c[0], a, bb[0], bb[1]);
    mma16816(c[1], a, bb[2], bb[3]);
  }
}

// Rows [row0, row0 + 64) of one head into a staged tile, asynchronously;
// rows at or past L are zero.  Eight threads per row, 16 bytes each.
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int b, int row0,
                                                int L, int heads, int h) {
#pragma unroll
  for (int it = 0; it < kTile * 8 / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads, r = i >> 3, ch = i & 7;
    const bool ok = row0 + r < L;
    cp_async16(dst + r * kLd + ch * 8, ok ? row_ptr(src, b, row0 + r, L, heads, h) + ch * 8 : src,
               ok);
  }
}

// 64 f32 of a [B, heads, L] row vector from r0 (zero past L), by threads
// [t0, t0 + 64).
__device__ __forceinline__ void load_vec_async(float* dst, const float* src, int r0, int L,
                                               int t0) {
  const int i = threadIdx.x - t0;
  if (i >= 0 && i < kTile) cp_async4(dst + i, r0 + i < L ? src + r0 + i : src, r0 + i < L);
}

// The first key tile at or after j that the query tile at r0 does not skip.
__device__ __forceinline__ int next_key(const Spec& sp, int r0, int j, int n, int L) {
  while (j < n && sp.skip(r0, j * kTile, L)) ++j;
  return j;
}

// The first query tile at or after i that the key tile at c0 does not skip.
__device__ __forceinline__ int next_query(const Spec& sp, int c0, int i, int n, int L) {
  while (i < n && sp.skip(i * kTile, c0, L)) ++i;
  return i;
}

constexpr size_t kFwdTcSmem = 5 * kTileH * sizeof(bf16);
constexpr size_t kDkdvTcSmem =
    6 * kTileH * sizeof(bf16) + 4 * kTile * sizeof(float) + 2 * kTile * sizeof(int2);
constexpr size_t kDqTcSmem = 6 * kTileH * sizeof(bf16) + kTile * sizeof(float4);

// K1, bf16.  Grid (query tiles, heads, B); warp w owns query rows
// r0 + 16 w + [0, 16).
__global__ void __launch_bounds__(kThreads)
attn_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ spec,
                   bf16* __restrict__ o, float* __restrict__ lse, Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KV = Qs + kTileH;  // stage s: K at KV + 2 s kTileH, V after it
  const int h = blockIdx.y, b = blockIdx.z, L = a.L;
  const int r0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const Spec sp = make_spec(spec, b, a);
  const Dropout dr = make_dropout(b, h, a);
  const int n = a.n_tiles;
  const float sl2 = a.scale_log2e, neg2 = kNeg * kLog2e;

  load_tile_async(Qs, q, b, r0, L, a.heads, h);
  cp_async_commit();
  int j = next_key(sp, r0, 0, n, L);
  if (j < n) {
    load_tile_async(KV, k, b, j * kTile, L, a.heads, h);
    load_tile_async(KV + kTileH, v, b, j * kTile, L, a.heads, h);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[4][4];
  load_a(qf, Qs, warp * 16, lane);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's columns
  int lo[2];
  unsigned span[2];  // row i sees columns [lo, lo + span)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int hi;
    sp.cols(r0 + warp * 16 + g + 8 * i, lo[i], hi);
    span[i] = static_cast<unsigned>(hi - lo[i]);
  }
  float acc[8][4];
  zero(acc);
  for (int stage = 0; j < n; stage ^= 1) {
    const int jn = next_key(sp, r0, j + 1, n, L);
    if (jn < n) {
      bf16* nxt = KV + (stage ^ 1) * 2 * kTileH;
      load_tile_async(nxt, k, b, jn * kTile, L, a.heads, h);
      load_tile_async(nxt + kTileH, v, b, jn * kTile, L, a.heads, h);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Ks = KV + stage * 2 * kTileH;
    const bf16* Vs = Ks + kTileH;
    const int c0 = j * kTile;

    float s[8][4];
    zero(s);
    mma_row<false>(s, qf, Ks, lane);  // S = Q K^T
    float mx[2] = {-INFINITY, -INFINITY};
    // both of this thread's rows see every column of a tile below L: no
    // per-cell test (true for whole warps but near the mask's edges)
    bool whole = c0 + kTile <= L;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      whole = whole && c0 >= lo[i] && c0 + kTile - lo[i] <= static_cast<int>(span[i]);
    if (whole) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] *= sl2;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, c = c0 + nt * 8 + 2 * tq + (e & 1);
          const bool vis = static_cast<unsigned>(c - lo[i]) < span[i];
          const float x = fmaf(s[nt][e], sl2, vis ? 0.f : neg2);
          s[nt][e] = c < L ? x : -INFINITY;
          mx[i] = fmaxf(mx[i], s[nt][e]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);  // finite: column c0 < L is in range
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][2 * i] *= alpha;
        acc[nt][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nt][e] - m[e >> 1]);
        l[e >> 1] += p;  // the undropped row sum
        if (dr.on) {  // 1 / (1 - rate) is applied to O at the end
          const int r = r0 + warp * 16 + g + 8 * (e >> 1), c = c0 + nt * 8 + 2 * tq + (e & 1);
          p = dr.keep(r, c) ? p : 0.f;
        }
        s[nt][e] = p;
      }
    uint32_t pa[4][4];
    to_a(pa, s);
    mma_row<true>(acc, pa, Vs, lane);  // O += P_keep V
    __syncthreads();  // this stage is free for the load two tiles on
    j = jn;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = r0 + warp * 16 + g + 8 * i;
    if (r >= L) continue;
    const float inv = (dr.on ? dr.scale : 1.f) / lt;
    bf16* dst = const_cast<bf16*>(row_ptr<bf16>(o, b, r, L, a.heads, h)) + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<uint32_t*>(dst + nt * 8) =
          pack_bf16(acc[nt][2 * i] * inv, acc[nt][2 * i + 1] * inv);
    if (tq == 0) lse[(static_cast<size_t>(b) * a.heads + h) * L + r] = (m[i] + log2f(lt)) * kLn2;
  }
}

// K2, bf16: dK and dV for one key tile (warp w owns keys c0 + 16 w +
// [0, 16)), looping over the query tiles it does not skip.
__global__ void __launch_bounds__(kThreads, 4)
attn_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dvec,
                        const int* __restrict__ spec, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTileH;
  bf16* QD = Vs + kTileH;  // stage s: Q at QD + 2 s kTileH, dO after it
  float* vec = reinterpret_cast<float*>(QD + 4 * kTileH);  // stage s: lse, Dvec at 2 s kTile
  int2* ivl = reinterpret_cast<int2*>(vec + 4 * kTile);  // stage s: (lo, span) of each row
  const int h = blockIdx.y, b = blockIdx.z, L = a.L;
  const int c0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const Spec sp = make_spec(spec, b, a);
  const Dropout dr = make_dropout(b, h, a);
  const int n = a.n_tiles;
  const float sl2 = a.scale_log2e, neg2 = kNeg * kLog2e;
  const size_t row_base = dr.base;  // (b * heads + h) * L

  load_tile_async(Ks, k, b, c0, L, a.heads, h);
  load_tile_async(Vs, v, b, c0, L, a.heads, h);
  int i = next_query(sp, c0, 0, n, L);
  auto load_stage = [&](int s, int it) {
    bf16* dst = QD + s * 2 * kTileH;
    load_tile_async(dst, q, b, it * kTile, L, a.heads, h);
    load_tile_async(dst + kTileH, dout, b, it * kTile, L, a.heads, h);
    load_vec_async(vec + s * 2 * kTile, lse + row_base, it * kTile, L, 0);
    load_vec_async(vec + s * 2 * kTile + kTile, dvec + row_base, it * kTile, L, kTile);
  };
  if (i < n) load_stage(0, i);
  cp_async_commit();

  float acc_dk[8][4], acc_dv[8][4];
  zero(acc_dk);
  zero(acc_dv);
  for (int stage = 0; i < n; stage ^= 1) {
    const int in = next_query(sp, c0, i + 1, n, L);
    if (in < n) load_stage(stage ^ 1, in);
    cp_async_commit();
    if (threadIdx.x < kTile) {  // the columns each query row of this tile sees
      int lo, hi;
      sp.cols(i * kTile + threadIdx.x, lo, hi);
      ivl[stage * kTile + threadIdx.x] = make_int2(lo, hi - lo);
    }
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qs = QD + stage * 2 * kTileH;
    const bf16* dOs = Qs + kTileH;
    const float* lse_s = vec + stage * 2 * kTile;
    const float* dvec_s = lse_s + kTile;
    const int r0 = i * kTile;

    // S^T = K Q^T and dP^T = V dO^T (rows keys, columns queries), 16
    // queries at a time, each made into P_drop^T and dS^T A fragments and
    // its share of dV += P_drop^T dO and dK += dS^T Q at once
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float st[2][4] = {}, dpt[2][4] = {};
      mma_pair(st, Ks, warp * 16, Qs, 2 * kk, lane);
      mma_pair(dpt, Vs, warp * 16, dOs, 2 * kk, lane);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int rl = (2 * kk + t) * 8 + 2 * tq;  // this thread's query rows: rl, rl + 1
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + rl);
        const float2 dvs = *reinterpret_cast<const float2*>(dvec_s + rl);
#pragma unroll
        for (int jr = 0; jr < 2; ++jr) {
          const int r = r0 + rl + jr;
          const float lse2 = (jr ? ls.y : ls.x) * kLog2e, dvr = jr ? dvs.y : dvs.x;
          const int2 iv = ivl[stage * kTile + rl + jr];
          const int lo = iv.x;
          const unsigned span = static_cast<unsigned>(iv.y);
#pragma unroll
          for (int ri = 0; ri < 2; ++ri) {
            const int e = 2 * ri + jr, c = c0 + warp * 16 + g + 8 * ri;
            float pd = 0.f, ds = 0.f;
            if (r < L && c < L) {
              const bool vis = static_cast<unsigned>(c - lo) < span;
              const float p = exp2f(fmaf(st[t][e], sl2, vis ? 0.f : neg2) - lse2);
              float dp = dpt[t][e];
              pd = p;
              if (dr.on) {
                const bool kp = dr.keep(r, c);
                dp = kp ? dp * dr.scale : 0.f;
                pd = kp ? p * dr.scale : 0.f;
              }
              ds = p * (dp - dvr);
            }
            st[t][e] = pd;
            dpt[t][e] = ds;
          }
        }
      }
      uint32_t af[4];
      pair_to_a(af, st);
      mma_k16<true>(acc_dv, af, dOs, kk, lane);  // dV += P_drop^T dO
      pair_to_a(af, dpt);
      mma_k16<true>(acc_dk, af, Qs, kk, lane);   // dK += dS^T Q
    }
    __syncthreads();
    i = in;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int c = c0 + warp * 16 + g + 8 * ri;
    if (c >= L) continue;
    bf16* dkp = const_cast<bf16*>(row_ptr<bf16>(dk, b, c, L, a.heads, h)) + 2 * tq;
    bf16* dvp = const_cast<bf16*>(row_ptr<bf16>(dv, b, c, L, a.heads, h)) + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<uint32_t*>(dkp + nt * 8) =
          pack_bf16(acc_dk[nt][2 * ri] * a.scale, acc_dk[nt][2 * ri + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvp + nt * 8) =
          pack_bf16(acc_dv[nt][2 * ri], acc_dv[nt][2 * ri + 1]);
    }
  }
}

// K2, bf16: dQ for one query tile (warp w owns rows r0 + 16 w + [0, 16)),
// looping over the key tiles it does not skip.
__global__ void __launch_bounds__(kThreads, 4)
attn_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dvec,
                      const int* __restrict__ spec, bf16* __restrict__ dq, Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kTileH;
  bf16* KV = dOs + kTileH;  // stage s: K at KV + 2 s kTileH, V after it
  // per query row: lse in log2 units, Dvec, and the columns [lo, lo + span)
  // it sees (kept here, not in registers, for 4 blocks per SM)
  float4* rows = reinterpret_cast<float4*>(KV + 4 * kTileH);
  const int h = blockIdx.y, b = blockIdx.z, L = a.L;
  const int r0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const Spec sp = make_spec(spec, b, a);
  const Dropout dr = make_dropout(b, h, a);
  const int n = a.n_tiles;
  const float sl2 = a.scale_log2e, neg2 = kNeg * kLog2e;
  const size_t row_base = dr.base;  // (b * heads + h) * L

  load_tile_async(Qs, q, b, r0, L, a.heads, h);
  load_tile_async(dOs, dout, b, r0, L, a.heads, h);
  cp_async_commit();
  int j = next_key(sp, r0, 0, n, L);
  if (j < n) {
    load_tile_async(KV, k, b, j * kTile, L, a.heads, h);
    load_tile_async(KV + kTileH, v, b, j * kTile, L, a.heads, h);
  }
  cp_async_commit();
  if (threadIdx.x < kTile) {
    const int r = r0 + threadIdx.x;
    int lo, hi;
    sp.cols(r, lo, hi);
    rows[threadIdx.x] = make_float4(r < L ? lse[row_base + r] * kLog2e : 0.f,
                                    r < L ? dvec[row_base + r] : 0.f, __int_as_float(lo),
                                    __int_as_float(hi - lo));
  }

  float acc[8][4];
  zero(acc);
  for (int stage = 0; j < n; stage ^= 1) {
    const int jn = next_key(sp, r0, j + 1, n, L);
    if (jn < n) {
      bf16* nxt = KV + (stage ^ 1) * 2 * kTileH;
      load_tile_async(nxt, k, b, jn * kTile, L, a.heads, h);
      load_tile_async(nxt + kTileH, v, b, jn * kTile, L, a.heads, h);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Ks = KV + stage * 2 * kTileH;
    const bf16* Vs = Ks + kTileH;
    const int c0 = j * kTile;

    // S = Q K^T and dP = dO V^T, 16 keys at a time, each made into a dS A
    // fragment and its share of dQ += dS K at once
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float sc[2][4] = {}, dp[2][4] = {};
      mma_pair(sc, Qs, warp * 16, Ks, 2 * kk, lane);
      mma_pair(dp, dOs, warp * 16, Vs, 2 * kk, lane);
      const float4 row_c[2] = {rows[warp * 16 + g], rows[warp * 16 + g + 8]};
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = e >> 1;
          const int r = r0 + warp * 16 + g + 8 * ri, c = c0 + (2 * kk + t) * 8 + 2 * tq + (e & 1);
          const float4 rc = row_c[ri];  // lse2, Dvec, lo, span
          float ds = 0.f;
          if (r < L && c < L) {
            const bool vis = static_cast<unsigned>(c - __float_as_int(rc.z)) <
                             static_cast<unsigned>(__float_as_int(rc.w));
            const float p = exp2f(fmaf(sc[t][e], sl2, vis ? 0.f : neg2) - rc.x);
            float dpv = dp[t][e];
            if (dr.on) dpv = dr.keep(r, c) ? dpv * dr.scale : 0.f;
            ds = p * (dpv - rc.y);
          }
          sc[t][e] = ds;
        }
      uint32_t af[4];
      pair_to_a(af, sc);
      mma_k16<true>(acc, af, Ks, kk, lane);  // dQ += dS K
    }
    __syncthreads();
    j = jn;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int r = r0 + warp * 16 + g + 8 * ri;
    if (r >= L) continue;
    bf16* dst = const_cast<bf16*>(row_ptr<bf16>(dq, b, r, L, a.heads, h)) + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<uint32_t*>(dst + nt * 8) =
          pack_bf16(acc[nt][2 * ri] * a.scale, acc[nt][2 * ri + 1] * a.scale);
  }
}

// ==================================================================== host

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
               const void* seed_ptr, unsigned seed, unsigned thresh, float drop_scale,
               float scale) {
  return Args{L,    heads,  img_block, l_real,     family, dropout,
              static_cast<const uint32_t*>(seed_ptr), seed, thresh, drop_scale, scale,
              scale * kLog2e, (L + kTile - 1) / kTile};
}

// One launch: lifts the kernel's shared-memory limit (once), launches it on
// grid x 128 threads, and returns the launch's error.
template <typename K, typename... P>
int launch(K kernel, size_t smem, bool& smem_set, dim3 grid, cudaStream_t s, P... args) {
  const cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

int fwd(const void* q, const void* k, const void* v, const int* spec, void* o, float* lse, int B,
        bool is_bf16, const Args& a, cudaStream_t s) {
  const dim3 grid((a.L + kTile - 1) / kTile, a.heads, B);
  if (is_bf16) {
    static bool set = false;
    return launch(attn_fwd_tc_kernel, kFwdTcSmem, set, grid, s, static_cast<const bf16*>(q),
                  static_cast<const bf16*>(k), static_cast<const bf16*>(v), spec,
                  static_cast<bf16*>(o), lse, a);
  }
  static bool set = false;
  return launch(attn_fwd_kernel, kFwdSmem, set, grid, s, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v), spec,
                static_cast<float*>(o), lse, a);
}

template <typename T>
int bwd_dot(const void* o, const void* dout, float* dvec, int B, const Args& a, cudaStream_t s) {
  const int rows = B * a.L * a.heads, per_block = kThreads * 16 / (kD * sizeof(T));
  attn_bwd_dot_kernel<T><<<(rows + per_block - 1) / per_block, kThreads, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), dvec, rows, a.L, a.heads);
  return static_cast<int>(cudaGetLastError());
}

int bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
        const float* lse, const int* spec, void* dq, void* dk, void* dv, float* dvec, int B,
        bool is_bf16, const Args& a, cudaStream_t s) {
  const dim3 grid((a.L + kTile - 1) / kTile, a.heads, B);
  int err;
  if (is_bf16) {
    using T = bf16;
    static bool dkdv_set = false, dq_set = false;
    if ((err = bwd_dot<T>(o, dout, dvec, B, a, s))) return err;
    if ((err = launch(attn_bwd_dkdv_tc_kernel, kDkdvTcSmem, dkdv_set, grid, s,
                      static_cast<const T*>(q), static_cast<const T*>(k),
                      static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                      static_cast<const float*>(dvec), spec, static_cast<T*>(dk),
                      static_cast<T*>(dv), a)))
      return err;
    return launch(attn_bwd_dq_tc_kernel, kDqTcSmem, dq_set, grid, s, static_cast<const T*>(q),
                  static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<const T*>(dout), lse, static_cast<const float*>(dvec), spec,
                  static_cast<T*>(dq), a);
  }
  using T = float;
  static bool dkdv_set = false, dq_set = false;
  if ((err = bwd_dot<T>(o, dout, dvec, B, a, s))) return err;
  if ((err = launch(attn_bwd_dkdv_kernel, kDkdvSmem, dkdv_set, grid, s, static_cast<const T*>(q),
                    static_cast<const T*>(k), static_cast<const T*>(v),
                    static_cast<const T*>(dout), lse, static_cast<const float*>(dvec), spec,
                    static_cast<T*>(dk), static_cast<T*>(dv), a)))
    return err;
  return launch(attn_bwd_dq_kernel, kDqSmem, dq_set, grid, s, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
                lse, static_cast<const float*>(dvec), spec, static_cast<T*>(dq), a);
}

}  // namespace

// q, k, v, o: [B, L, heads, 64] of f32 (is_bf16 = 0) or bf16, contiguous and
// 16-byte aligned; spec: int32 [B, 2]; lse: f32 [B, heads, L].  The Python
// wrapper checks every shape and type.
extern "C" int medvill_attn_fwd(const void* q, const void* k, const void* v, const int* spec,
                                void* o, float* lse, int B, int L, int heads, int is_bf16,
                                int img_block, int l_real, int family, int dropout,
                                const void* seed_ptr, unsigned int seed, unsigned int thresh,
                                float drop_scale, float scale, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  const Args a = make_args(L, heads, img_block, l_real, family, dropout, seed_ptr, seed,
                           thresh, drop_scale, scale);
  return fwd(q, k, v, spec, o, lse, B, is_bf16 != 0, a, static_cast<cudaStream_t>(stream));
}

// dout, dq, dk, dv: as q; dvec: f32 scratch [B, heads, L].
extern "C" int medvill_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const float* lse, const int* spec, void* dq,
                                void* dk, void* dv, float* dvec, int B, int L, int heads,
                                int is_bf16, int img_block, int l_real, int family, int dropout,
                                const void* seed_ptr, unsigned int seed, unsigned int thresh,
                                float drop_scale, float scale, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  const Args a = make_args(L, heads, img_block, l_real, family, dropout, seed_ptr, seed,
                           thresh, drop_scale, scale);
  return bwd(q, k, v, o, dout, lse, spec, dq, dk, dv, dvec, B, is_bf16 != 0, a,
             static_cast<cudaStream_t>(stream));
}
