// Fused dropout + residual-add + LayerNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel medvill_tpu/ops/fused_ln.py::_fwd_kernel
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
