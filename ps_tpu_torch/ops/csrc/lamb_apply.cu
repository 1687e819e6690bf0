// Fused multi-tensor LAMB step: optax.lamb's chain over every tensor of
// one optimizer step in two launches, whatever the number of tensors.
//
// Replaces no TPU kernel: the reference steps LAMB with optax inside one
// jitted apply (ps_tpu/optim/__init__.py, `lamb`), which XLA fuses over the
// whole tree. The port's plain version is optim.lamb's loop over the keys
// (ps_tpu_torch/optim/__init__.py), ~26 launches a tensor: 5,261 a
// BERT-base step, which hold the host ~100 ms while the card idles. This
// kernel is that loop's arithmetic in two launches.
//
// Bound: bytes. Phase 1 reads g, m, v and p and writes m and v (24 B a
// value); phase 2 reads m, v and p and writes p (16 B): 40 B a value, 4.4
// GB and 1.3 ms for BERT-base's 109.5 M values at 3.35 TB/s. A tensor's
// values can be stepped only once its norms ‖p‖ and ‖u‖ are known, so
// phase 2 computes u again from the new moments instead of reading it: a
// buffer of u for the whole tree would cost 0.44 GB of device memory.
//
// Design:
// - Work: the wrapper (ops/lamb_apply.py, chunk_table) cuts the tensors
//   into segments (tensor, offset, length) and groups them into chunks of
//   at most CHUNK values, once per list of tensor sizes: a large tensor is
//   cut into chunks of its own, small ones (LayerNorm's 768 values, the
//   biases) share a chunk. One block of 256 threads a chunk, in both
//   phases, so the hardware balances the blocks.
// - Phase 1: the moments in place and u in registers; each segment's Σp²
//   and Σu², reduced in a fixed order within the block, go to a scratch
//   slot of their own. No atomics: the sums repeat bitwise.
// - Phase 2: a block sums the slots of each of its tensors in a fixed
//   order (the same in every block of that tensor, so all agree on the
//   ratio), takes the trust ratio, computes u again and steps p. Its blocks
//   walk the chunks in reverse, so the first find the chunks phase 1
//   finished last still in the 50 MB L2.
// - Pointers: every tensor's p, g, m and v ride in the kernels' parameters
//   (__grid_constant__, up to kMaxTensors, 8 KB). Gradients move every
//   step, and the out-of-place paths move the parameters too, so nothing
//   that holds an address is kept on the card between calls.
// - 16-byte loads and stores where a segment's four addresses are 16-byte
//   aligned, scalar accesses otherwise, and a scalar tail.
// - Launched with launch_pdl: phase 2 is scheduled while phase 1 drains.
//
// Numerics: optax's expressions in float32, each rounded once, in the
// order optim.lamb's loop takes them; the _rn intrinsics keep nvcc from
// contracting any of them into an FMA. The moments then equal the loop's
// bitwise, and u too given the same bias corrections (powf, as PyTorch's
// pow); the norms are summed in another order than torch's vector_norm.
// `count` (optax's safe_increment, up to INT32_MAX) is read by phase 1,
// which puts the step's count in a scratch slot; phase 2 reads the slot and
// its block 0 writes `count`, so no block reads `count` while one writes
// it. With increment = 0 (the same call stepped other keys by the loop,
// which counted the step already) `count` is read and left as it is.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// tensors a launch pair takes; the wrapper cuts longer lists into groups
constexpr int kMaxTensors = 256;

struct Tensors {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
};
static_assert(sizeof(Tensors) <= 32764 - 256,
              "the tensor table must fit the kernels' parameters");

struct Hyper {
  const float* lr_ptr;  // the schedule's rate on the device, or null
  int* count;
  float lr, b1, omb1, b2, omb2, eps, wd;
  int increment;
};

struct Table {  // views into the wrapper's int64 chunk table
  const long long* chunk_first;  // [chunks + 1]
  const long long* seg_tensor;   // [segments]
  const long long* seg_offset;   // [segments]
  const long long* seg_len;      // [segments]
  const long long* tensor_seg;   // [tensors + 1]
};

struct Bias {  // the step's bias corrections and the update's constants
  float bc1, bc2, eps, wd;
};

__device__ __forceinline__ Bias bias(const Hyper& h, int count) {
  const float c = static_cast<float>(count);
  return {__fsub_rn(1.0f, powf(h.b1, c)), __fsub_rn(1.0f, powf(h.b2, c)),
          h.eps, h.wd};
}

// u = m̂ / (sqrt(v̂) + eps) + wd·p, as scale_by_adam then
// add_decayed_weights
__device__ __forceinline__ float adam_u(float m, float v, float p,
                                        const Bias& k) {
  const float mh = __fdiv_rn(m, k.bc1);
  const float vh = __fdiv_rn(v, k.bc2);
  const float u = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), k.eps));
  return __fadd_rn(u, __fmul_rn(k.wd, p));
}

// phase 1 on one value: the moments in place, Σp² and Σu²
__device__ __forceinline__ void moments(float g, float& m, float& v, float p,
                                        const Hyper& h, const Bias& k,
                                        float& sp, float& su) {
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  const float u = adam_u(m, v, p, k);
  sp = fmaf(p, p, sp);
  su = fmaf(u, u, su);
}

// phase 2 on one value: p + (-lr)·(u·ratio)
__device__ __forceinline__ float step(float m, float v, float p,
                                      const Bias& k, float ratio,
                                      float neg_lr) {
  return __fadd_rn(p, __fmul_rn(neg_lr, __fmul_rn(adam_u(m, v, p, k),
                                                  ratio)));
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b,
                                          const void* c, const void* d) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) &
          15) == 0;
}

// The block's sums of (a, b), in a fixed order, valid in thread 0. Ends
// with a barrier, so `red` may be used again at once.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  if (lane == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  float2 out = make_float2(0.0f, 0.0f);
  if (warp == 0) {
    a = lane < kWarps ? red[lane].x : 0.0f;
    b = lane < kWarps ? red[lane].y : 0.0f;
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, o);
      b += __shfl_down_sync(0xffffffffu, b, o);
    }
    out = make_float2(a, b);
  }
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kThreads)
    lamb_moments_kernel(const __grid_constant__ Tensors t, const Hyper h,
                        const Table tab, float* __restrict__ partials,
                        int* __restrict__ next_count) {
  ps::pdl_wait();
  __shared__ float2 red[kWarps];
  int count = *h.count;
  if (h.increment && count < INT_MAX) ++count;
  if (blockIdx.x == 0 && threadIdx.x == 0) *next_count = count;
  const Bias k = bias(h, count);
  const long long s1 = tab.chunk_first[blockIdx.x + 1];
  for (long long s = tab.chunk_first[blockIdx.x]; s < s1; ++s) {
    const int i = static_cast<int>(tab.seg_tensor[s]);
    const long long off = tab.seg_offset[s], n = tab.seg_len[s];
    float* p = t.p[i] + off;
    const float* g = t.g[i] + off;
    float* m = t.m[i] + off;
    float* v = t.v[i] + off;
    float sp = 0.0f, su = 0.0f;
    long long head = 0;
    if (aligned16(p, g, m, v)) {
      head = n / 4 * 4;
      for (long long j = threadIdx.x * 4ll; j < head; j += kThreads * 4) {
        const float4 g4 = __ldg(reinterpret_cast<const float4*>(g + j));
        float4 m4 = *reinterpret_cast<const float4*>(m + j);
        float4 v4 = *reinterpret_cast<const float4*>(v + j);
        const float4 p4 = *reinterpret_cast<const float4*>(p + j);
        moments(g4.x, m4.x, v4.x, p4.x, h, k, sp, su);
        moments(g4.y, m4.y, v4.y, p4.y, h, k, sp, su);
        moments(g4.z, m4.z, v4.z, p4.z, h, k, sp, su);
        moments(g4.w, m4.w, v4.w, p4.w, h, k, sp, su);
        *reinterpret_cast<float4*>(m + j) = m4;
        *reinterpret_cast<float4*>(v + j) = v4;
      }
    }
    for (long long j = head + threadIdx.x; j < n; j += kThreads) {
      float mj = m[j], vj = v[j];
      moments(g[j], mj, vj, p[j], h, k, sp, su);
      m[j] = mj;
      v[j] = vj;
    }
    const float2 sums = block_sum2(sp, su, red);
    if (threadIdx.x == 0) {
      partials[2 * s] = sums.x;
      partials[2 * s + 1] = sums.y;
    }
  }
  ps::pdl_trigger();
}

__global__ void __launch_bounds__(kThreads)
    lamb_update_kernel(const __grid_constant__ Tensors t, const Hyper h,
                       const Table tab, int n_chunks,
                       const float* __restrict__ partials,
                       const int* __restrict__ next_count) {
  ps::pdl_wait();
  __shared__ float2 red[kWarps];
  __shared__ float ratio_s;
  const int count = *next_count;
  if (h.increment && blockIdx.x == 0 && threadIdx.x == 0) *h.count = count;
  const Bias k = bias(h, count);
  const float neg_lr = -(h.lr_ptr != nullptr ? *h.lr_ptr : h.lr);
  const int c = n_chunks - 1 - static_cast<int>(blockIdx.x);
  const long long s1 = tab.chunk_first[c + 1];
  for (long long s = tab.chunk_first[c]; s < s1; ++s) {
    const int i = static_cast<int>(tab.seg_tensor[s]);
    // the tensor's norms: its segments' sums, added in a fixed order
    float sp = 0.0f, su = 0.0f;
    const long long last = tab.tensor_seg[i + 1];
    for (long long j = tab.tensor_seg[i] + threadIdx.x; j < last;
         j += kThreads) {
      sp += partials[2 * j];
      su += partials[2 * j + 1];
    }
    const float2 sums = block_sum2(sp, su, red);
    if (threadIdx.x == 0) {
      const float pn = __fsqrt_rn(sums.x), un = __fsqrt_rn(sums.y);
      ratio_s = (pn == 0.0f || un == 0.0f) ? 1.0f : __fdiv_rn(pn, un);
    }
    __syncthreads();
    const float ratio = ratio_s;
    const long long off = tab.seg_offset[s], n = tab.seg_len[s];
    float* p = t.p[i] + off;
    const float* m = t.m[i] + off;
    const float* v = t.v[i] + off;
    long long head = 0;
    if (aligned16(p, p, m, v)) {
      head = n / 4 * 4;
      for (long long j = threadIdx.x * 4ll; j < head; j += kThreads * 4) {
        const float4 m4 = *reinterpret_cast<const float4*>(m + j);
        const float4 v4 = *reinterpret_cast<const float4*>(v + j);
        float4 p4 = *reinterpret_cast<const float4*>(p + j);
        p4.x = step(m4.x, v4.x, p4.x, k, ratio, neg_lr);
        p4.y = step(m4.y, v4.y, p4.y, k, ratio, neg_lr);
        p4.z = step(m4.z, v4.z, p4.z, k, ratio, neg_lr);
        p4.w = step(m4.w, v4.w, p4.w, k, ratio, neg_lr);
        *reinterpret_cast<float4*>(p + j) = p4;
      }
    }
    for (long long j = head + threadIdx.x; j < n; j += kThreads) {
      p[j] = step(m[j], v[j], p[j], k, ratio, neg_lr);
    }
  }
}

}  // namespace

extern "C" {

// ptrs: a host array of 4 * n_tensors addresses, the p of every tensor,
// then every g, m and v (contiguous f32 on `device`). table: the wrapper's
// int64 chunk table on the device, chunk_first [n_chunks + 1], then
// seg_tensor, seg_offset and seg_len [n_segments each], then tensor_seg
// [n_tensors + 1]. scratch: 2 * n_segments + 1 f32 slots on the device
// (the segments' sums, then the step's count). count: the int32 step
// count on the device; lr_ptr: the f32 rate on the device, or null to use
// `lr`. omb1 and omb2 are 1 - b1 and 1 - b2 as the caller rounds them.
// Launches both phases on `stream`, does not synchronise, and returns the
// first CUDA error of the set-up or the launches (0 if none).
int ps_lamb_apply(const long long* ptrs, int n_tensors, const void* table,
                  long long n_chunks, long long n_segments, void* scratch,
                  void* count, const void* lr_ptr, float lr, float b1,
                  float omb1, float b2, float omb2, float eps, float wd,
                  int increment, int device, void* stream) {
  if (n_tensors <= 0 || n_chunks <= 0) return 0;
  if (n_tensors > kMaxTensors || n_chunks > INT_MAX || n_segments <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Tensors t = {};
  for (int i = 0; i < n_tensors; ++i) {
    t.p[i] = reinterpret_cast<float*>(ptrs[i]);
    t.g[i] = reinterpret_cast<const float*>(ptrs[n_tensors + i]);
    t.m[i] = reinterpret_cast<float*>(ptrs[2 * n_tensors + i]);
    t.v[i] = reinterpret_cast<float*>(ptrs[3 * n_tensors + i]);
  }
  const Hyper h = {static_cast<const float*>(lr_ptr), static_cast<int*>(count),
                   lr, b1, omb1, b2, omb2, eps, wd, increment};
  const long long* base = static_cast<const long long*>(table);
  const Table tab = {base, base + n_chunks + 1,
                     base + n_chunks + 1 + n_segments,
                     base + n_chunks + 1 + 2 * n_segments,
                     base + n_chunks + 1 + 3 * n_segments};
  float* partials = static_cast<float*>(scratch);
  int* next_count = reinterpret_cast<int*>(partials + 2 * n_segments);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_chunks));
  err = ps::launch_pdl(lamb_moments_kernel, grid, dim3(kThreads), 0, s, t, h,
                       tab, partials, next_count);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = ps::launch_pdl(lamb_update_kernel, grid, dim3(kThreads), 0, s, t, h,
                       tab, static_cast<int>(n_chunks),
                       static_cast<const float*>(partials),
                       static_cast<const int*>(next_count));
  return static_cast<int>(err);
}

const char* ps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
