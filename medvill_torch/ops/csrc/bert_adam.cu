// BertAdam's update for Hopper (sm_90a) in two launches: the per-tensor
// gradient norms, then the update itself.
//
// It replaces no TPU kernel.  The JAX package leaves the update to XLA,
// which fuses optax's chain into a few passes; the port's plain version
// (medvill_torch/train/optim.py, BertAdam's foreach chain) runs about
// thirteen multi-tensor passes over every trained tensor, three of them out
// of place, plus one more to clear the gradients: ~29 four-byte accesses
// per element.  These two kernels compute the same update in the same f32
// and the same order of operations.
//
// Bound: memory.  The norms read g once (4 B per element); the update reads
// p, g, m and v and writes p, m and v, and zero into g where the caller
// clears the gradients (32 B).  36 B per element: for the report-generation
// finetune's 111.7 M trained elements 4.0 GB, 1.20 ms at 3.35 TB/s on an
// H100 SXM.  The ~15 flops per element are far below the ridge point.
//
// Design:
//   - one launch table for both kernels, built by the wrapper
//     (medvill_torch/ops/bert_adam.py) and kept on the device: per tensor a
//     row of kRow int64 (the addresses of p, g, m, v and the group's device
//     lr; its size, decay, first chunk and chunk count, and whether all its
//     addresses are 16-byte aligned), then per chunk of at most `chunk`
//     elements (tensor, start).  Addresses do not change from update to
//     update, so a CUDA graph that captured the launches reads a table that
//     stays valid at every replay.  A tensor with no gradient has g null
//     and reads zeros.
//   - one block per chunk in both launches; 16-byte vector loads and stores
//     where the tensor's addresses are aligned, a scalar loop for the tail
//     (the 30522 bias) and for unaligned pieces (ZeRO-1's spans).
//   - the norms without atomics: each norm block writes its chunk's sum of
//     squares; each update block sums its tensor's partials in a fixed
//     order before it starts, so every block of a tensor gets the same
//     norm, bit for bit from run to run and replay to replay.  Where the
//     caller gives the norms (tensors that lie over several ranks), the
//     norm launch does not run and the update reads them.
//   - the arithmetic rounds where the chain rounds: each foreach pass
//     stores an f32, and inside a pass PyTorch's `a + alpha * b` and
//     `a + value * (b * c)` contract into one fma, as they do here.
//     Explicit _rn intrinsics keep nvcc from contracting anything else.
//     The clip is the chain's: min(1, reciprocal(norm + 1e-6) * max_norm).
//
// C interface for ctypes: pointers and the stream as void*, returns
// cudaGetLastError() after the launch.  Allocates nothing; runs on `stream`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the fields of a tensor's row (medvill_torch/ops/bert_adam.py: FIELDS)
enum Field { kP, kG, kM, kV, kNumel, kLr, kWd, kFirst, kCount, kAligned, kRow };

struct Hyper {
  float b1, b2, a1, a2, eps, max_norm;
  int clip, clear;
};

// The block's sum of x, in a fixed order, returned to every thread.
__device__ __forceinline__ float block_sum(float x, float* smem) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  x = lane < kWarps ? smem[lane] : 0.f;
  for (int o = kWarps / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if (threadIdx.x == 0) smem[kWarps] = x;
  __syncthreads();
  return smem[kWarps];
}

__device__ __forceinline__ float sq_sum4(float4 a, float s) {
  s = __fmaf_rn(a.x, a.x, s);
  s = __fmaf_rn(a.y, a.y, s);
  s = __fmaf_rn(a.z, a.z, s);
  return __fmaf_rn(a.w, a.w, s);
}

// One element: the chain's passes, each rounded where it stores.
__device__ __forceinline__ void adam(float& p, float g, float& m, float& v, const Hyper& h,
                                     float c, float wd, float lr) {
  const float gc = __fmul_rn(g, c);
  m = __fmaf_rn(h.a1, gc, __fmul_rn(m, h.b1));
  v = __fmaf_rn(h.a2, __fmul_rn(gc, gc), __fmul_rn(v, h.b2));
  float u = __fdiv_rn(m, __fadd_rn(__fsqrt_rn(v), h.eps));
  if (wd > 0.f) u = __fmaf_rn(wd, p, u);
  p = __fadd_rn(p, __fmul_rn(u, lr));
}

__global__ void __launch_bounds__(kThreads)
    bert_adam_norm_kernel(const int64_t* __restrict__ table, int n_tensors, int chunk,
                          float* __restrict__ partials) {
  __shared__ float smem[kWarps + 1];
  const int64_t* link = table + (static_cast<int64_t>(n_tensors) * kRow + 2 * blockIdx.x);
  const int64_t* row = table + link[0] * kRow;
  const int64_t start = link[1];
  const int64_t n = min(static_cast<int64_t>(chunk), row[kNumel] - start);
  const float* g = reinterpret_cast<const float*>(row[kG]);
  float s = 0.f;
  if (g != nullptr) {
    g += start;
    int64_t tail = 0;
    if (row[kAligned]) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      const int64_t n4 = n >> 2;
      for (int64_t i = threadIdx.x; i < n4; i += kThreads) s = sq_sum4(g4[i], s);
      tail = n4 << 2;
    }
    for (int64_t i = tail + threadIdx.x; i < n; i += kThreads) s = __fmaf_rn(g[i], g[i], s);
  }
  s = block_sum(s, smem);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
    bert_adam_update_kernel(const int64_t* __restrict__ table, int n_tensors, int chunk,
                            const float* __restrict__ partials, const float* __restrict__ norms,
                            Hyper h) {
  __shared__ float smem[kWarps + 1];
  const int64_t* link = table + (static_cast<int64_t>(n_tensors) * kRow + 2 * blockIdx.x);
  const int64_t t = link[0];
  const int64_t* row = table + t * kRow;
  const int64_t start = link[1];
  const int64_t n = min(static_cast<int64_t>(chunk), row[kNumel] - start);
  float c = 1.f;
  if (h.clip) {
    float norm;
    if (norms != nullptr) {
      norm = norms[t];
    } else {
      const float* part = partials + row[kFirst];
      const int64_t count = row[kCount];
      float s = 0.f;
      for (int64_t i = threadIdx.x; i < count; i += kThreads) s = __fadd_rn(s, part[i]);
      norm = __fsqrt_rn(block_sum(s, smem));
    }
    c = __fmul_rn(__frcp_rn(__fadd_rn(norm, 1e-6f)), h.max_norm);
    if (c > 1.f) c = 1.f;  // torch.clamp(max=1): a NaN stays NaN
  }
  float* p = reinterpret_cast<float*>(row[kP]) + start;
  float* g = reinterpret_cast<float*>(row[kG]);
  float* m = reinterpret_cast<float*>(row[kM]) + start;
  float* v = reinterpret_cast<float*>(row[kV]) + start;
  if (g != nullptr) g += start;
  const float lr = *reinterpret_cast<const float*>(row[kLr]);
  const float wd = __int_as_float(static_cast<int>(row[kWd]));
  const bool clear = h.clear && g != nullptr;
  int64_t tail = 0;
  if (row[kAligned]) {
    float4* p4 = reinterpret_cast<float4*>(p);
    float4* g4 = reinterpret_cast<float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const int64_t n4 = n >> 2;
    for (int64_t i = threadIdx.x; i < n4; i += kThreads) {
      float4 pp = p4[i], mm = m4[i], vv = v4[i];
      const float4 gg = g != nullptr ? g4[i] : zero;
      adam(pp.x, gg.x, mm.x, vv.x, h, c, wd, lr);
      adam(pp.y, gg.y, mm.y, vv.y, h, c, wd, lr);
      adam(pp.z, gg.z, mm.z, vv.z, h, c, wd, lr);
      adam(pp.w, gg.w, mm.w, vv.w, h, c, wd, lr);
      p4[i] = pp;
      m4[i] = mm;
      v4[i] = vv;
      if (clear) g4[i] = zero;
    }
    tail = n4 << 2;
  }
  for (int64_t i = tail + threadIdx.x; i < n; i += kThreads) {
    float pp = p[i], mm = m[i], vv = v[i];
    adam(pp, g != nullptr ? g[i] : 0.f, mm, vv, h, c, wd, lr);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
    if (clear) g[i] = 0.f;
  }
}

}  // namespace

// The chunks' sums of squares of g into partials[n_chunks].
extern "C" int medvill_bert_adam_norm(const void* table, int n_tensors, int n_chunks, int chunk,
                                      void* partials, void* stream) {
  if (n_chunks <= 0) return 0;
  bert_adam_norm_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(table), n_tensors, chunk, static_cast<float*>(partials));
  return static_cast<int>(cudaGetLastError());
}

// The update of every tensor of the table.  clip: scale each gradient by
// min(1, max_norm / (||g|| + 1e-6)), the norm from norms[tensor] where norms
// is not null, else from the norm launch's partials.  clear: zero g.
extern "C" int medvill_bert_adam_update(const void* table, int n_tensors, int n_chunks,
                                        int chunk, const void* partials, const void* norms,
                                        int clip, float b1, float b2, float a1, float a2,
                                        float eps, float max_norm, int clear, void* stream) {
  if (n_chunks <= 0) return 0;
  const Hyper h{b1, b2, a1, a2, eps, max_norm, clip, clear};
  bert_adam_update_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(table), n_tensors, chunk, static_cast<const float*>(partials),
      static_cast<const float*>(norms), h);
  return static_cast<int>(cudaGetLastError());
}
