// Fused sparse apply for one embedding table: segment sum + row-wise
// optimizer apply, in one launch, in place.
//
// Replaces the TPU kernel in ps_tpu/ops/sparse_apply.py (_make_kernel and
// _apply_pallas, pl.pallas_call at l.297), together with the
// batch_segment_sum that feeds it. It is not that kernel carried over block
// by block: the Pallas version walks a deduped id list with one DMA chain
// per row; here the wrapper sorts the pushed ids once (stable, on the
// device) and one warp per sorted position finds, sums and applies its own
// segment, so no dedupe pass, no host sync and no float atomics are needed.
//
// What it computes, for each unique real id r (id -1 is filler):
//   gsum = sum of grads[j] over the pushes j of r, in f32, in arrival order
//   (table[r], state[r]) <- apply_rows(table[r], state[r], gsum, cnt)
// with the rules of ps_tpu_torch/optim/rowwise.py: sgd (no state), adagrad
// (one f32 accumulator per row, += mean_D(g^2)) and lazy adam (m, v [R, D]
// f32, t [R] int32, per-row bias correction). Untouched rows are neither
// read nor written, and there is no output copy.
//
// What bounds it: memory. Per apply it must read the grads and ids,
// N * (D * 4 + 4) bytes (the wrapper's sort adds the int64 order, 8 more
// per id), and read and write the U touched rows with their state,
// 2 * U * (D * sizeof(T) + state bytes). At the Wide-&-Deep shapes (N =
// 13,312 ids, D = 16) that is about 1-2 MB, under a microsecond at
// 3.35 TB/s, so launch latency dominates. This first design aims at
// correctness and determinism: each segment is summed sequentially by one
// warp (lanes cover D), every operation whose rounding the plain version
// fixes is written with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn /
// __fsqrt_rn so nvcc cannot contract it into an FMA, and two runs on the
// same inputs give the same bits. Speed is for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Rule { kSgd = 0, kAdagrad = 1, kAdam = 2 };

struct Hyper {
  float lr, b1, b2, omb1, omb2, eps;  // omb = 1 - b, rounded from double
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// gsum[d] of one segment: f32, from 0, in arrival order.
__device__ __forceinline__ float segment_sum(const float* __restrict__ grads,
                                             const int64_t* __restrict__ order,
                                             int64_t begin, int64_t end,
                                             int64_t dim, int64_t d) {
  float s = 0.f;
  for (int64_t j = begin; j < end; ++j) {
    s = __fadd_rn(s, grads[order[j] * dim + d]);
  }
  return s;
}

// rows - step.to(rows.dtype), rounded as the plain version rounds it.
template <typename T>
__device__ __forceinline__ void sub_step(T* __restrict__ p, float step) {
  *p = from_f<T>(__fsub_rn(to_f(*p), to_f(from_f<T>(step))));
}

// One warp per sorted position i. The warp goes on only where i starts the
// segment of a real id; it then walks the segment, and its lanes cover D.
template <int RULE, typename T>
__global__ void sparse_apply_kernel(T* __restrict__ table,
                                    float* __restrict__ st_a,
                                    float* __restrict__ st_b,
                                    int32_t* __restrict__ st_t,
                                    const int32_t* __restrict__ ids_s,
                                    const int64_t* __restrict__ order,
                                    const float* __restrict__ grads,
                                    int64_t n, int64_t dim, int64_t num_rows,
                                    Hyper h) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;  // i is the same for the whole warp: uniform exits
  const int32_t id = ids_s[i];
  if (id < 0 || id >= num_rows) return;
  if (i > 0 && ids_s[i - 1] == id) return;
  int64_t end = i + 1;
  while (end < n && ids_s[end] == id) ++end;
  const int64_t row = static_cast<int64_t>(id) * dim;

  if (RULE == kSgd) {
    for (int64_t d = lane; d < dim; d += 32) {
      const float g = segment_sum(grads, order, i, end, dim, d);
      // rows - lr * gsum.to(rows.dtype), with lr and gsum rounded to T
      // first (the reference's weak-typed scalar) and the product too
      const float step = __fmul_rn(to_f(from_f<T>(h.lr)), to_f(from_f<T>(g)));
      sub_step(&table[row + d], step);
    }
  } else if (RULE == kAdagrad) {
    float sq = 0.f;
    for (int64_t d = lane; d < dim; d += 32) {
      const float g = segment_sum(grads, order, i, end, dim, d);
      sq = __fadd_rn(sq, __fmul_rn(g, g));
    }
    for (int off = 16; off > 0; off >>= 1) {
      sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, off));
    }
    const float acc =
        __fadd_rn(st_a[id], __fdiv_rn(sq, static_cast<float>(dim)));
    const float denom = __fsqrt_rn(__fadd_rn(acc, h.eps));
    for (int64_t d = lane; d < dim; d += 32) {
      const float g = segment_sum(grads, order, i, end, dim, d);
      sub_step(&table[row + d], __fdiv_rn(__fmul_rn(h.lr, g), denom));
    }
    __syncwarp();  // every lane has read st_a[id] before lane 0 writes it
    if (lane == 0) st_a[id] = acc;
  } else {
    const int32_t t = st_t[id] + 1;
    const float tf = static_cast<float>(t);
    const float bc1 = __fsub_rn(1.f, powf(h.b1, tf));
    const float bc2 = __fsub_rn(1.f, powf(h.b2, tf));
    for (int64_t d = lane; d < dim; d += 32) {
      const float g = segment_sum(grads, order, i, end, dim, d);
      const int64_t k = row + d;
      const float m = __fadd_rn(__fmul_rn(h.b1, st_a[k]), __fmul_rn(h.omb1, g));
      const float v = __fadd_rn(__fmul_rn(h.b2, st_b[k]),
                                __fmul_rn(__fmul_rn(h.omb2, g), g));
      const float mhat = __fdiv_rn(m, bc1);
      const float vhat = __fdiv_rn(v, bc2);
      const float step = __fdiv_rn(__fmul_rn(h.lr, mhat),
                                   __fadd_rn(__fsqrt_rn(vhat), h.eps));
      st_a[k] = m;
      st_b[k] = v;
      sub_step(&table[k], step);
    }
    __syncwarp();  // every lane has read st_t[id] before lane 0 writes it
    if (lane == 0) st_t[id] = t;
  }
}

template <int RULE, typename T>
void launch(void* table, void* st_a, void* st_b, void* st_t,
            const void* ids_s, const void* order, const void* grads,
            int64_t n, int64_t dim, int64_t num_rows, Hyper h,
            cudaStream_t stream) {
  const int threads = 256;  // 8 warps, 8 sorted positions per block
  const int64_t blocks = (n * 32 + threads - 1) / threads;
  sparse_apply_kernel<RULE, T><<<static_cast<unsigned>(blocks), threads, 0,
                                 stream>>>(
      static_cast<T*>(table), static_cast<float*>(st_a),
      static_cast<float*>(st_b), static_cast<int32_t*>(st_t),
      static_cast<const int32_t*>(ids_s), static_cast<const int64_t*>(order),
      static_cast<const float*>(grads), n, dim, num_rows, h);
}

}  // namespace

extern "C" {

// rule: 0 sgd, 1 adagrad (st_a = acc [R]), 2 adam (st_a = m, st_b = v
// [R, D], st_t = t [R]); is_bf16 selects the table type (else f32).
// ids_s [n] int32 sorted, order [n] int64 the stable sort's permutation,
// grads [n, dim] f32 in arrival order. Returns cudaGetLastError().
int ps_sparse_apply(int rule, int is_bf16, void* table, void* st_a,
                    void* st_b, void* st_t, const void* ids_s,
                    const void* order, const void* grads, long long n,
                    long long dim, long long num_rows, float lr, float b1,
                    float b2, float omb1, float omb2, float eps, int device,
                    void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Hyper h{lr, b1, b2, omb1, omb2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PS_LAUNCH(R, T) \
  launch<R, T>(table, st_a, st_b, st_t, ids_s, order, grads, n, dim, num_rows, h, s)
  if (is_bf16) {
    if (rule == kSgd) PS_LAUNCH(kSgd, __nv_bfloat16);
    else if (rule == kAdagrad) PS_LAUNCH(kAdagrad, __nv_bfloat16);
    else if (rule == kAdam) PS_LAUNCH(kAdam, __nv_bfloat16);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (rule == kSgd) PS_LAUNCH(kSgd, float);
    else if (rule == kAdagrad) PS_LAUNCH(kAdagrad, float);
    else if (rule == kAdam) PS_LAUNCH(kAdam, float);
    else return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PS_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

const char* ps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
