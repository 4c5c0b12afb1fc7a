// Fused dropout + residual-add + LayerNorm for Hopper (sm_90a): forward
// (K3) and backward (K4).
//
// K3 replaces the TPU kernel medvill_tpu/ops/fused_ln.py::_fwd_kernel
// (with _keep_mask and _stats): y = LN(dropout(x) + res) * gamma + beta,
// f32 row statistics, output in x's dtype.
//
// Bound: memory.  Per row it reads x and res and writes y once, so the least
// time is (2 reads + 1 write) * R * H * sizeof(T) / 3.35 TB/s on an H100
// SXM; the ~10 flops per element are far below the card's ridge point.  The
// design therefore touches each byte once and keeps everything between the
// load and the store in registers:
//   - one warp per row (H <= 1024), four rows per 128-thread block, so even
//     the 16-row decode window fills four blocks and no block waits on
//     another (the TPU kernel's 256-row tile carried no meaning here);
//   - 16-byte vector loads of x and res (8 bf16 or 4 f32 per lane per chunk,
//     neighbouring lanes on neighbouring chunks);
//   - the row stays in registers: mean by warp shuffle, then the variance as
//     the mean of squared deviations (the TPU kernel's two-pass _stats), then
//     one 16-byte store per chunk.  No shared memory, no atomics.
//
// Dropout keep mask: a pure function of (seed, row, col), kept iff
// fmix32(seed ^ (row * H + col)) >= floor(rate * 2^32), all in uint32
// arithmetic.  medvill_torch/ops/fused_ln.py::keep_mask computes the same
// bits, so the kernel and its plain version agree bit for bit at any rate;
// neither gives the TPU PRNG's bits.
//
// K4 replaces medvill_tpu/ops/fused_ln.py::_bwd_kernel: it recomputes the
// keep mask and the row statistics from (x, res, seed), then
// ds = rstd * (dy*g - mean(dy*g) - xhat * mean(dy*g*xhat)), dres = ds,
// dx = ds * keep / (1 - rate), and the partial sums dgamma = sum dy*xhat,
// dbeta = sum dy.  Bound: memory, 3 reads (x, res, dy) and 2 writes (dx,
// dres) per element.  K3's row layout again (one warp per row, the row in
// registers, 16-byte vectors); each block of 4 warps walks a chunk of 64
// rows, keeps its dgamma/dbeta sums in registers, reduces them across its
// warps in shared memory and writes one f32 partial row, so the [n_blocks,
// H] partials stay small (246 rows at R = 15696) and are summed outside the
// kernel, as the JAX code sums its per-block partials.  The TPU kernel's
// (8, H) slab per 256-row block is a TPU tiling artifact and is not copied.
//
// C interface for ctypes: pointers and the stream as void*, returns
// cudaGetLastError() after the launch.  Allocates nothing; runs on `stream`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16 bytes of T, unpacked to / packed from f32.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  using Raw = float4;
  __device__ static void unpack(const Raw& r, float* v) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  __device__ static Raw pack(const float* v) { return make_float4(v[0], v[1], v[2], v[3]); }
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
  __device__ static Raw pack(const float* v) {
    Raw r;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return r;
  }
};

// MAXC: most 16-byte chunks one lane holds (H <= 32 * MAXC * N).
template <typename T, int MAXC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    T* __restrict__ y, int rows, int h, int dropout, uint32_t seed,
                    uint32_t thresh, float scale, float eps) {
  using V = Vec16<T>;
  constexpr int N = V::N;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int chunks = h / N;
  const size_t base = static_cast<size_t>(row) * h;
  const typename V::Raw* xr = reinterpret_cast<const typename V::Raw*>(x + base);
  const typename V::Raw* rr = reinterpret_cast<const typename V::Raw*>(res + base);

  float v[MAXC][N];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
      float a[N], b[N];
      V::unpack(xr[c], a);
      V::unpack(rr[c], b);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float xv = a[j];
        if (dropout) {
          const uint32_t idx = static_cast<uint32_t>(row) * static_cast<uint32_t>(h) +
                               static_cast<uint32_t>(c * N + j);
          xv = fmix32(seed ^ idx) >= thresh ? xv * scale : 0.f;
        }
        v[i][j] = xv + b[j];
        sum += v[i][j];
      }
    }
  }
  const float mean = warp_sum(sum) / h;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    if (lane + 32 * i < chunks) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float d = v[i][j] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = 1.f / sqrtf(warp_sum(sq) / h + eps);

  typename V::Raw* yr = reinterpret_cast<typename V::Raw*>(y + base);
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const float4* b4 = reinterpret_cast<const float4*>(beta);
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
      float out[N];
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 g = g4[c * (N / 4) + q];
        const float4 bb = b4[c * (N / 4) + q];
        out[4 * q + 0] = (v[i][4 * q + 0] - mean) * rstd * g.x + bb.x;
        out[4 * q + 1] = (v[i][4 * q + 1] - mean) * rstd * g.y + bb.y;
        out[4 * q + 2] = (v[i][4 * q + 2] - mean) * rstd * g.z + bb.z;
        out[4 * q + 3] = (v[i][4 * q + 3] - mean) * rstd * g.w + bb.w;
      }
      yr[c] = V::pack(out);
    }
  }
}

constexpr int kBwdRowsPerBlock = 64;
constexpr int kMaxH = 1024;

template <typename T, int MAXC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                    const float* __restrict__ gamma, const T* __restrict__ dy,
                    T* __restrict__ dx, T* __restrict__ dres, float* __restrict__ dgamma_part,
                    float* __restrict__ dbeta_part, int rows, int h, int dropout,
                    uint32_t seed, uint32_t thresh, float scale, float eps) {
  using V = Vec16<T>;
  constexpr int N = V::N;
  static_assert(MAXC * N <= 32, "the keep bits of a lane fit one uint32");
  __shared__ float red_g[kWarpsPerBlock][kMaxH];
  __shared__ float red_b[kWarpsPerBlock][kMaxH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = h / N;
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  float acc_g[MAXC][N], acc_b[MAXC][N];
#pragma unroll
  for (int i = 0; i < MAXC; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc_g[i][j] = acc_b[i][j] = 0.f;

  const int row0 = static_cast<int>(blockIdx.x) * kBwdRowsPerBlock;
  const int row_end = min(rows, row0 + kBwdRowsPerBlock);
  for (int row = row0 + warp; row < row_end; row += kWarpsPerBlock) {
    const size_t base = static_cast<size_t>(row) * h;
    const typename V::Raw* xr = reinterpret_cast<const typename V::Raw*>(x + base);
    const typename V::Raw* rr = reinterpret_cast<const typename V::Raw*>(res + base);
    const typename V::Raw* dyr = reinterpret_cast<const typename V::Raw*>(dy + base);
    float v[MAXC][N], d[MAXC][N];
    uint32_t keep_bits = 0xffffffffu;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
        float a[N], b[N];
        V::unpack(xr[c], a);
        V::unpack(rr[c], b);
        V::unpack(dyr[c], d[i]);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          float xv = a[j];
          if (dropout) {
            const uint32_t idx = static_cast<uint32_t>(row) * static_cast<uint32_t>(h) +
                                 static_cast<uint32_t>(c * N + j);
            if (fmix32(seed ^ idx) >= thresh) {
              xv *= scale;
            } else {
              xv = 0.f;
              keep_bits &= ~(1u << (i * N + j));
            }
          }
          v[i][j] = xv + b[j];
          sum += v[i][j];
        }
      }
    }
    const float mean = warp_sum(sum) / h;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      if (lane + 32 * i < chunks) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float e = v[i][j] - mean;
          sq += e * e;
        }
      }
    }
    const float rstd = 1.f / sqrtf(warp_sum(sq) / h + eps);
    // v becomes xhat, d stays dy; sums of dy*g and dy*g*xhat
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const float4 g = g4[c * (N / 4) + q];
          const float gg[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * q + e;
            v[i][j] = (v[i][j] - mean) * rstd;
            const float dyg = d[i][j] * gg[e];
            s1 += dyg;
            s2 += dyg * v[i][j];
            acc_g[i][j] += d[i][j] * v[i][j];
            acc_b[i][j] += d[i][j];
          }
        }
      }
    }
    const float m1 = warp_sum(s1) / h;
    const float m2 = warp_sum(s2) / h;
    typename V::Raw* dxr = reinterpret_cast<typename V::Raw*>(dx + base);
    typename V::Raw* drr = reinterpret_cast<typename V::Raw*>(dres + base);
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
        float ds[N], dxv[N];
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const float4 g = g4[c * (N / 4) + q];
          const float gg[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * q + e;
            ds[j] = rstd * (d[i][j] * gg[e] - m1 - v[i][j] * m2);
            dxv[j] = dropout ? ((keep_bits >> (i * N + j)) & 1u ? ds[j] * scale : 0.f) : ds[j];
          }
        }
        drr[c] = V::pack(ds);
        dxr[c] = V::pack(dxv);
      }
    }
  }

  // the block's dgamma / dbeta: lane sums -> per-warp rows -> one partial row
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        red_g[warp][c * N + j] = acc_g[i][j];
        red_b[warp][c * N + j] = acc_b[i][j];
      }
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < h; col += kWarpsPerBlock * 32) {
    float g = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) {
      g += red_g[w][col];
      b += red_b[w][col];
    }
    dgamma_part[static_cast<size_t>(blockIdx.x) * h + col] = g;
    dbeta_part[static_cast<size_t>(blockIdx.x) * h + col] = b;
  }
}

}  // namespace

// is_bf16: 1 for bf16 x/res/y, 0 for f32.  h must be a multiple of the
// 16-byte vector (8 bf16 / 4 f32) and at most 1024; the Python wrapper checks.
extern "C" int medvill_fused_ln_fwd(const void* x, const void* res, const void* gamma,
                                    const void* beta, void* y, int rows, int h,
                                    int is_bf16, int dropout, unsigned int seed,
                                    unsigned int thresh, float scale, float eps,
                                    void* stream) {
  if (rows <= 0) return 0;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  if (is_bf16) {
    fused_ln_fwd_kernel<__nv_bfloat16, 4><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(res), g, b,
        static_cast<__nv_bfloat16*>(y), rows, h, dropout, seed, thresh, scale, eps);
  } else {
    fused_ln_fwd_kernel<float, 8><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(res), g, b,
        static_cast<float*>(y), rows, h, dropout, seed, thresh, scale, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4.  dy, dx, dres: like x; dgamma_part, dbeta_part: f32 [n_blocks, h] with
// n_blocks = ceil(rows / 64), summed over blocks by the caller.
extern "C" int medvill_fused_ln_bwd(const void* x, const void* res, const void* gamma,
                                    const void* dy, void* dx, void* dres, void* dgamma_part,
                                    void* dbeta_part, int rows, int h, int is_bf16,
                                    int dropout, unsigned int seed, unsigned int thresh,
                                    float scale, float eps, void* stream) {
  if (rows <= 0) return 0;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((rows + kBwdRowsPerBlock - 1) / kBwdRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  float* pg = static_cast<float*>(dgamma_part);
  float* pb = static_cast<float*>(dbeta_part);
  if (is_bf16) {
    using T = __nv_bfloat16;
    fused_ln_bwd_kernel<T, 4><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(res), g, static_cast<const T*>(dy),
        static_cast<T*>(dx), static_cast<T*>(dres), pg, pb, rows, h, dropout, seed, thresh,
        scale, eps);
  } else {
    fused_ln_bwd_kernel<float, 8><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(res), g,
        static_cast<const float*>(dy), static_cast<float*>(dx), static_cast<float*>(dres), pg,
        pb, rows, h, dropout, seed, thresh, scale, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
