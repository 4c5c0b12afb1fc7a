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
// neither gives the TPU PRNG's bits.  The seed is the launch's uint32 plus,
// where seed_ptr is not null, the uint32 at seed_ptr in device memory (the
// JAX kernels' seed_ref): a CUDA graph that captured the launch keeps the
// constant and reads the word anew at every replay, so the host rewrites
// the word between replays and each replay draws a fresh mask.
//
// K4 replaces medvill_tpu/ops/fused_ln.py::_bwd_kernel: it recomputes the
// keep mask and the two-pass row statistics from (x, res, seed), then
// ds = rstd * (dy*g - mean(dy*g) - xhat * mean(dy*g*xhat)), dres = ds,
// dx = ds * keep / (1 - rate), and dgamma = sum dy*xhat, dbeta = sum dy
// over all rows, f32 [H].  The TPU kernel's (8, H) slab per 256-row block
// is a TPU tiling artifact and is not copied.
//
// Bound: memory, 3 reads (x, res, dy) and 2 writes (dx, dres) per element:
// 120 MB, 36 us at R = 15696, H = 768, bf16 on an H100 SXM.  What held a
// first design (blocks of 4 warps over 64-row chunks, each warp loading,
// reducing and storing one row at a time, and a second launch summing one
// dgamma/dbeta row per block) to 47% of that: ~7.5 warps per SM, 114 SMs
// with two chunks and 18 with one, no load issued while a row was reduced.
// This design:
//   - a persistent grid sized from the card: resident blocks per SM (CUDA's
//     occupancy calculator, asked once by the wrapper) x SMs.  Block b walks
//     rows [b R / n, (b + 1) R / n), so shares differ by at most one row; its
//     warps take those rows in turn, one warp per row (K3's layout: 16-byte
//     vectors, a lane holding C chunks, C a template argument sized to H, 3
//     for bf16 at 768).  A block is 16 warps where a lane's state fits 128
//     registers (bf16 up to H = 768), so one block fills an SM's registers
//     and the grid is one block per SM; else 8 warps.
//   - each warp streams its rows through a two-stage ring in shared memory
//     filled by cp.async, each lane copying the chunks it will read: while
//     row k is reduced and stored, row k + 1 is in flight (and row k + 2
//     while the warp waits), 4.6-9.2 KB per warp at H = 768 bf16.
//   - dgamma / dbeta in the same launch, with no floating-point atomics: a
//     lane sums its columns over its warp's rows in registers, the block
//     adds its warps' sums in warp order into one f32 partial row, the last
//     block of each group of ~sqrt(n) blocks to finish (an integer ticket,
//     acquire-release) adds its group's rows in block order, and the last
//     group adds the group rows in group order.  The order is fixed, so the
//     sums are bit-identical from call to call; each ticket is set back to
//     zero by its last arrival, ready for the next call (and for every
//     replay of a CUDA graph that captured the call).
// On an H100 SXM this reaches two thirds of the bound.  What holds the
// rest is mostly the per-row arithmetic (keep hash, statistics, four warp
// reductions) that 16 warps per SM do not hide; PERF.md has the A/B.
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
                    T* __restrict__ y, int rows, int h, int dropout,
                    const uint32_t* __restrict__ seed_ptr, uint32_t seed, uint32_t thresh,
                    float scale, float eps) {
  using V = Vec16<T>;
  if (dropout && seed_ptr) seed += __ldg(seed_ptr);
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

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous, through L2 only.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kBwdStages = 2;  // rows in a warp's ring

// Warps per K4 block: 16, one block filling an SM's registers at under 128
// a lane, where the lane's state allows it (bf16 up to C = 3, f32 up to 4);
// else 8.
template <typename T, int C>
__host__ __device__ constexpr int bwd_warps() {
  return C * Vec16<T>::N <= 24 && C <= 4 ? 16 : 8;
}

// Dynamic shared memory of a K4 block at width h: each warp's ring.
template <typename T, int C>
constexpr size_t bwd_smem(int h) {
  return static_cast<size_t>(bwd_warps<T, C>()) * kBwdStages * 3 * h * sizeof(T);
}

// Called by every thread of the block once its global writes are done: true
// in the block that arrives last of `count` at `ticket`, which then sees the
// others' writes (read through L2, __ldcg); that block sets the ticket back
// to zero.  One thread takes the ticket, after the barrier, with an
// acquire-release atomic: the release carries the block's writes (ordered
// before it by the barrier) and the acquire the earlier arrivals'.
__device__ bool arrive_last(unsigned* ticket, unsigned count) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned t;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;\n" : "=r"(t) : "l"(ticket) : "memory");
    last = t == count - 1;
    if (last) atomicExch(ticket, 0u);
  }
  __syncthreads();
  return last;
}

// dst[col] = the sum of src[r * width + col] over r = 0 .. n - 1, in that
// order; width % 4 == 0.
__device__ void sum_rows(const float* src, int n, int width, float* dst) {
  const int w4 = width / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int col = threadIdx.x; col < w4; col += blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int r = 0; r < n; ++r) {
      const float4 v = __ldcg(s4 + static_cast<size_t>(r) * w4 + col);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    d4[col] = acc;
  }
}

// C: 16-byte chunks a lane holds (h <= 32 * C * N).  dgb: f32 [2, h]
// (dgamma, dbeta); scratch: f32 [2 * gridDim.x, 2 * h], the blocks' partial
// rows and then the groups'; tickets: one per group of `group` blocks and
// one more, zero.
template <typename T, int C>
__global__ void __launch_bounds__(bwd_warps<T, C>() * 32, 1)
fused_ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                    const float* __restrict__ gamma, const T* __restrict__ dy,
                    T* __restrict__ dx, T* __restrict__ dres, float* __restrict__ dgb,
                    float* __restrict__ scratch, unsigned* __restrict__ tickets, int rows,
                    int h, int group, int dropout, const uint32_t* __restrict__ seed_ptr,
                    uint32_t seed, uint32_t thresh, float scale, float eps) {
  using V = Vec16<T>;
  if (dropout && seed_ptr) seed += __ldg(seed_ptr);
  using Raw = typename V::Raw;
  constexpr int N = V::N, kWarps = bwd_warps<T, C>();
  static_assert(C * N <= 32, "the keep bits of a lane fit one uint32");
  static_assert(kBwdStages * 3 * sizeof(T) >= 2 * sizeof(float),
                "a warp's ring holds its dgamma/dbeta sums");
  extern __shared__ __align__(16) unsigned char bwd_ring[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = h / N;
  const float inv_h = 1.f / h;
  // this warp's ring: kBwdStages rows, each x | res | dy as `chunks` vectors
  Raw* const ring = reinterpret_cast<Raw*>(bwd_ring) + warp * (kBwdStages * 3 * chunks);
  const float4* g4 = reinterpret_cast<const float4*>(gamma);

  const int nb = gridDim.x;
  const int row_end = static_cast<int>(static_cast<long long>(rows) * (blockIdx.x + 1) / nb);
  int row = static_cast<int>(static_cast<long long>(rows) * blockIdx.x / nb) + warp;

  auto fetch = [&](int r, int stage) {
    const size_t base = static_cast<size_t>(r) * h;
    const Raw* src[3] = {reinterpret_cast<const Raw*>(x + base),
                         reinterpret_cast<const Raw*>(res + base),
                         reinterpret_cast<const Raw*>(dy + base)};
    Raw* dst = ring + stage * 3 * chunks;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int c = lane + 32 * i;
        if (c < chunks) cp_async16(dst + t * chunks + c, src[t] + c);
      }
    }
  };

  float acc_g[C][N], acc_b[C][N];
#pragma unroll
  for (int i = 0; i < C; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc_g[i][j] = acc_b[i][j] = 0.f;

  if (row < row_end) fetch(row, 0);
  cp_async_commit();
  for (int k = 0; row < row_end; row += kWarps, ++k) {
    if (row + kWarps < row_end) fetch(row + kWarps, (k + 1) % kBwdStages);
    cp_async_commit();
    cp_async_wait<kBwdStages - 1>();  // this row's copies have landed
    const Raw* cur = ring + (k % kBwdStages) * 3 * chunks;

    float v[C][N];
    uint32_t keep_bits = 0xffffffffu;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
        float a[N], b[N];
        V::unpack(cur[c], a);
        V::unpack(cur[chunks + c], b);
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
    const float mean = warp_sum(sum) * inv_h;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (lane + 32 * i < chunks) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float e = v[i][j] - mean;
          sq += e * e;
        }
      }
    }
    const float rstd = 1.f / sqrtf(warp_sum(sq) * inv_h + eps);
    const float shift = -mean * rstd;
    // v becomes xhat; sums of dy*g and dy*g*xhat; the lane's dgamma/dbeta
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
        float d[N];
        V::unpack(cur[2 * chunks + c], d);
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const float4 g = g4[c * (N / 4) + q];
          const float gg[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * q + e;
            v[i][j] = fmaf(v[i][j], rstd, shift);
            const float dyg = d[j] * gg[e];
            s1 += dyg;
            s2 += dyg * v[i][j];
            acc_g[i][j] += d[j] * v[i][j];
            acc_b[i][j] += d[j];
          }
        }
      }
    }
    warp_sum2(s1, s2);
    // ds = rstd * (dy*g - m1 - xhat * m2) = dy*g * rstd + (xhat * c2 + c1)
    const float c1 = -rstd * s1 * inv_h, c2 = -rstd * s2 * inv_h;
    const size_t base = static_cast<size_t>(row) * h;
    Raw* dxr = reinterpret_cast<Raw*>(dx + base);
    Raw* drr = reinterpret_cast<Raw*>(dres + base);
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
        float d[N], ds[N], dxv[N];
        V::unpack(cur[2 * chunks + c], d);
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const float4 g = g4[c * (N / 4) + q];
          const float gg[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * q + e;
            ds[j] = fmaf(d[j] * gg[e], rstd, fmaf(v[i][j], c2, c1));
            dxv[j] = dropout ? ((keep_bits >> (i * N + j)) & 1u ? ds[j] * scale : 0.f) : ds[j];
          }
        }
        drr[c] = V::pack(ds);
        dxr[c] = V::pack(dxv);
      }
    }
  }
  cp_async_wait<0>();

  // the block's partial row: each warp's sums into its own (now idle) ring,
  // then added over the warps in order
  float* const red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const int j = 4 * q;
        reinterpret_cast<float4*>(red + c * N)[q] =
            make_float4(acc_g[i][j], acc_g[i][j + 1], acc_g[i][j + 2], acc_g[i][j + 3]);
        reinterpret_cast<float4*>(red + h + c * N)[q] =
            make_float4(acc_b[i][j], acc_b[i][j + 1], acc_b[i][j + 2], acc_b[i][j + 3]);
      }
    }
  }
  __syncthreads();
  const int width = 2 * h;
  const int ring_floats = kBwdStages * 3 * h * static_cast<int>(sizeof(T)) / 4;
  const float* red_all = reinterpret_cast<const float*>(bwd_ring);
  float* const part = scratch + static_cast<size_t>(blockIdx.x) * width;
  for (int col = threadIdx.x; col < width; col += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red_all[w * ring_floats + col];
    part[col] = s;
  }

  // the sum over blocks: per group of blocks, then over the groups
  const int n_groups = (nb + group - 1) / group;
  const int g = blockIdx.x / group, first = g * group;
  const int members = min(group, nb - first);
  if (!arrive_last(&tickets[g], members)) return;
  const float* block_rows = scratch + static_cast<size_t>(first) * width;
  if (n_groups == 1) {
    sum_rows(block_rows, members, width, dgb);
    return;
  }
  float* const group_rows = scratch + static_cast<size_t>(nb) * width;
  sum_rows(block_rows, members, width, group_rows + static_cast<size_t>(g) * width);
  if (!arrive_last(&tickets[n_groups], n_groups)) return;
  sum_rows(group_rows, n_groups, width, dgb);
}

struct BwdArgs {
  const void *x, *res, *gamma, *dy;
  void *dx, *dres, *dgb, *scratch, *tickets;
  int rows, h, n_blocks, dropout;
  const uint32_t* seed_ptr;
  uint32_t seed, thresh;
  float scale, eps;
  cudaStream_t stream;
};

// One call of the K4 instantiation <T, C>: its resident blocks per SM at
// width a.h and its warps per block into occupancy[0], [1] when that is
// given, else the launch.  Lifts the kernel's shared-memory limit to its
// widest h first, once (the wrapper asks the occupancy before the first
// launch, so never inside a CUDA graph capture).
template <typename T, int C>
int bwd_run(const BwdArgs& a, int* occupancy) {
  const auto kernel = fused_ln_bwd_kernel<T, C>;
  constexpr int threads = bwd_warps<T, C>() * 32;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bwd_smem<T, C>(32 * C * Vec16<T>::N)));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const size_t smem = bwd_smem<T, C>(a.h);
  if (occupancy) {
    occupancy[1] = threads / 32;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel, threads, smem));
  }
  int group = 1;  // ~sqrt(n_blocks) blocks per group, so both sums are short
  while (group * group < a.n_blocks) ++group;
  kernel<<<a.n_blocks, threads, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.res),
      static_cast<const float*>(a.gamma), static_cast<const T*>(a.dy), static_cast<T*>(a.dx),
      static_cast<T*>(a.dres), static_cast<float*>(a.dgb), static_cast<float*>(a.scratch),
      static_cast<unsigned*>(a.tickets), a.rows, a.h, group, a.dropout, a.seed_ptr, a.seed,
      a.thresh,
      a.scale, a.eps);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation whose lanes hold the fewest chunks that cover a.h.
int bwd_dispatch(bool is_bf16, const BwdArgs& a, int* occupancy) {
  if (is_bf16) {
    const int c = (a.h / 8 + 31) / 32;
    if (c <= 1) return bwd_run<__nv_bfloat16, 1>(a, occupancy);
    if (c <= 2) return bwd_run<__nv_bfloat16, 2>(a, occupancy);
    if (c <= 3) return bwd_run<__nv_bfloat16, 3>(a, occupancy);
    if (c <= 4) return bwd_run<__nv_bfloat16, 4>(a, occupancy);
  } else {
    const int c = (a.h / 4 + 31) / 32;
    if (c <= 1) return bwd_run<float, 1>(a, occupancy);
    if (c <= 2) return bwd_run<float, 2>(a, occupancy);
    if (c <= 4) return bwd_run<float, 4>(a, occupancy);
    if (c <= 6) return bwd_run<float, 6>(a, occupancy);
    if (c <= 8) return bwd_run<float, 8>(a, occupancy);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// is_bf16: 1 for bf16 x/res/y, 0 for f32.  h must be a multiple of the
// 16-byte vector (8 bf16 / 4 f32) and at most 1024; the Python wrapper checks.
extern "C" int medvill_fused_ln_fwd(const void* x, const void* res, const void* gamma,
                                    const void* beta, void* y, int rows, int h,
                                    int is_bf16, int dropout, const void* seed_ptr,
                                    unsigned int seed, unsigned int thresh, float scale,
                                    float eps, void* stream) {
  if (rows <= 0) return 0;
  const uint32_t* sp = static_cast<const uint32_t*>(seed_ptr);
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  if (is_bf16) {
    fused_ln_fwd_kernel<__nv_bfloat16, 4><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(res), g, b,
        static_cast<__nv_bfloat16*>(y), rows, h, dropout, sp, seed, thresh, scale, eps);
  } else {
    fused_ln_fwd_kernel<float, 8><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(res), g, b,
        static_cast<float*>(y), rows, h, dropout, sp, seed, thresh, scale, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4 at width h: out[0] its resident blocks per SM, out[1] its warps per
// block, out[2] the device's SMs; the wrapper's grid is at most
// out[0] * out[2] blocks.
extern "C" int medvill_fused_ln_bwd_occupancy(int h, int is_bf16, int* out) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&out[2], cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  BwdArgs a{};
  a.h = h;
  return bwd_dispatch(is_bf16 != 0, a, out);
}

// K4 on n_blocks blocks (any count is right; more than the resident blocks
// only runs in waves).  dy, dx, dres: like x; dgb: f32 [2, h], dgamma then
// dbeta; scratch: f32 [2 * n_blocks, 2 * h]; tickets: uint32
// [n_blocks + 1], zero at entry and left zero.
extern "C" int medvill_fused_ln_bwd(const void* x, const void* res, const void* gamma,
                                    const void* dy, void* dx, void* dres, void* dgb,
                                    void* scratch, void* tickets, int rows, int h,
                                    int n_blocks, int is_bf16, int dropout,
                                    const void* seed_ptr, unsigned int seed,
                                    unsigned int thresh, float scale, float eps,
                                    void* stream) {
  if (rows <= 0 || n_blocks <= 0) return 0;
  const BwdArgs a{x, res, gamma, dy, dx, dres, dgb, scratch, tickets, rows, h, n_blocks,
                  dropout, static_cast<const uint32_t*>(seed_ptr), seed, thresh, scale, eps,
                  static_cast<cudaStream_t>(stream)};
  return bwd_dispatch(is_bf16 != 0, a, nullptr);
}
