// Fused sparse apply for one embedding table: segment sum + row-wise
// optimizer apply, one launch, in place, one segment per worker.
//
// Replaces the TPU kernel in ps_tpu/ops/sparse_apply.py (_make_kernel and
// _apply_pallas, pl.pallas_call at l.297), together with the
// batch_segment_sum at l.80 that feeds it; csrc/sparse_group.cu is the
// grouping half. It is not that kernel carried over block by block: the
// Pallas version walks a deduped id list with one DMA chain per row; here
// the grouping pass has sorted the pushed ids stably and written one entry
// per unique real id (its start, end and id), and each worker takes one
// segment, so no dedupe pass, no host sync and no float atomics are needed.
//
// What it computes, for each segment (unique real id r):
//   gsum = sum of grads[j] over the pushes j of r, in f32, from 0, in
//          arrival order (the sorted order is stable)
//   (table[r], state[r]) <- apply_rows(table[r], state[r], gsum, cnt)
// with the rules of ps_tpu_torch/optim/rowwise.py: sgd (no state), adagrad
// (one f32 accumulator per row, += mean_D(g^2)) and lazy adam (m, v [R, D]
// f32, t [R] int32, per-row bias correction). Untouched rows are neither
// read nor written, filler ids' grads are never read, and there is no
// output copy.
//
// What bounds it on an H100: bytes would allow well under a microsecond at
// the Wide-&-Deep shapes (N = 13,312 grads of D = 16, ~0.5 us at 3.35
// TB/s), so what is left is latency: the chain of dependent loads each
// segment needs (its table entry, its positions, its grads) and, for a hot
// id with ~90-180 duplicates, the chain of f32 adds the arrival order fixes.
// The design keeps every load off that chain:
//
// - a worker is G lanes sized to D (G = 1 for D = 1, so one warp takes 32
//   segments; G = 16 for D <= 16, two segments a warp; G = 32 above, each
//   lane two of every 64 dims);
// - the worker reads its segment's start, end and id in one step and issues
//   the row's and its state's loads at once, before the grads arrive;
// - positions come 32 at a time, coalesced, and pass between the worker's
//   lanes by shuffle; all 32 grads rows of a tile are in flight together
//   (every load unconditional, with clamped addresses: a load under a
//   branch waits for the one before it), and the next tile's grads and
//   the positions of the one after load while this tile is summed, so
//   only the f32 adds are serial; a segment longer than a tile (a hot id
//   with 100,000 duplicates) goes on tile by tile, strictly in order;
// - adagrad keeps the summed row in registers between its norm and its
//   update (D <= 64; wider rows walk the segment again).
//
// Every operation whose rounding the plain version fixes is written with
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn so nvcc cannot
// contract it into an FMA, and two runs on the same inputs give the same
// bits. Tensor cores play no part: the card's part in this is many warps
// with loads in flight, warp shuffles, and programmatic dependent launch
// (launch.cuh) so this grid is scheduled while the grouping pass runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

enum Rule { kSgd = 0, kAdagrad = 1, kAdam = 2 };

constexpr int kThreads = 256;
// positions a worker loads at a time, by worker width
template <int G>
constexpr int kTile = G == 16 ? 16 : 32;
// whether a worker loads the next tile while it sums this one (registers
// for a second tile; where they cost resident warps, it does not)
template <int G>
constexpr bool kPrefetch = G == 1;
// resident blocks an SM, at least (caps the registers a thread)
template <int G>
constexpr int kMinBlocks = G == 16 ? 3 : 1;

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

// rows - step.to(rows.dtype), rounded as the plain version rounds it.
template <typename T>
__device__ __forceinline__ T sub_step(T old, float step) {
  return from_f<T>(__fsub_rn(to_f(old), to_f(from_f<T>(step))));
}

// The worker's positions p [kTile / G] of the tile at `base`: lane `sub`
// holds perm[base + k * G + sub]. Past `end` it loads the segment's last
// position again: every load is unconditional, so all of a tile's loads
// are issued before the first is used (a load under a branch would wait
// for the one before it, and a hot id's tile would cost 32 latencies).
template <int G>
__device__ __forceinline__ void load_positions(int (&p)[kTile<G> / G],
                                               const int32_t* __restrict__ perm,
                                               int64_t base, int64_t end,
                                               int sub) {
#pragma unroll
  for (int k = 0; k < kTile<G> / G; ++k) {
    const int64_t j = base + k * G + sub;
    p[k] = __ldg(&perm[j < end ? j : end - 1]);
  }
}

// The grads rows of one tile: g[q][k] = grads[pos_q, c0 + sub + k * G],
// every load issued before any is used (lanes past dim load dim - 1).
template <int G, int DPL>
__device__ __forceinline__ void load_grads(float (&g)[kTile<G>][DPL],
                                           const int (&p)[kTile<G> / G],
                                           const float* __restrict__ grads,
                                           int64_t dim, int64_t c0, int sub,
                                           unsigned mask) {
#pragma unroll
  for (int q = 0; q < kTile<G>; ++q) {
    const int pos = G == 1 ? p[q] : __shfl_sync(mask, p[q / G], q % G, G);
#pragma unroll
    for (int k = 0; k < DPL; ++k) {
      const int64_t d = c0 + sub + k * G;
      g[q][k] = __ldg(&grads[static_cast<int64_t>(pos) * dim +
                             (d < dim ? d : dim - 1)]);
    }
  }
}

// gsum over one segment [beg, end) for the worker's dims c0 + sub + k * G
// (k < DPL): f32, from 0, in sorted (= arrival) order. While a tile is
// summed, the next tile's positions are in flight, and with kPrefetch its
// grads too, so a hot id costs about one load latency a tile.
template <int G, int DPL>
__device__ __forceinline__ void segment_sum(float (&s)[DPL],
                                            const float* __restrict__ grads,
                                            const int32_t* __restrict__ perm,
                                            int64_t beg, int64_t end,
                                            int64_t dim, int64_t c0, int sub,
                                            unsigned mask) {
#pragma unroll
  for (int k = 0; k < DPL; ++k) s[k] = 0.f;
  constexpr int kT = kTile<G>;
  int p[kT / G];
  load_positions<G>(p, perm, beg, end, sub);
  float g[kT][DPL];
  if constexpr (kPrefetch<G>) {
    load_grads<G, DPL>(g, p, grads, dim, c0, sub, mask);
    if (beg + kT < end) load_positions<G>(p, perm, beg + kT, end, sub);
  }
  for (int64_t base = beg; base < end; base += kT) {
    float next[kT][DPL];
    if constexpr (kPrefetch<G>) {
      if (base + kT < end) {
        load_grads<G, DPL>(next, p, grads, dim, c0, sub, mask);
        if (base + 2 * kT < end) {
          load_positions<G>(p, perm, base + 2 * kT, end, sub);
        }
      }
    } else {
      load_grads<G, DPL>(g, p, grads, dim, c0, sub, mask);
      if (base + kT < end) load_positions<G>(p, perm, base + kT, end, sub);
    }
#pragma unroll
    for (int q = 0; q < kT; ++q) {
      if (base + q < end) {
#pragma unroll
        for (int k = 0; k < DPL; ++k) s[k] = __fadd_rn(s[k], g[q][k]);
      }
    }
    if constexpr (kPrefetch<G>) {
#pragma unroll
      for (int q = 0; q < kT; ++q) {
#pragma unroll
        for (int k = 0; k < DPL; ++k) g[q][k] = next[q][k];
      }
    }
  }
}

template <int G>
__device__ __forceinline__ float group_sum(float x, unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    x = __fadd_rn(x, __shfl_xor_sync(mask, x, off, G));
  }
  return x;
}

template <int RULE, typename T, int G>
__device__ __forceinline__ void apply_segment(
    T* __restrict__ table, float* __restrict__ st_a, float* __restrict__ st_b,
    int32_t* __restrict__ st_t, const float* __restrict__ grads,
    const int32_t* __restrict__ perm, int64_t beg, int64_t end, int32_t id,
    int64_t dim, const Hyper& h, int sub, unsigned mask) {
  constexpr int DPL = G == 32 ? 2 : 1;  // dims a lane, per chunk
  constexpr int CW = G * DPL;           // dims a chunk
  const int64_t row = static_cast<int64_t>(id) * dim;
  float s[DPL];
  T old[DPL];
  auto load_row = [&](int64_t c0) {
#pragma unroll
    for (int k = 0; k < DPL; ++k) {
      const int64_t d = c0 + sub + k * G;
      old[k] = d < dim ? table[row + d] : from_f<T>(0.f);
    }
  };

  if (RULE == kSgd) {
    // rows - lr * gsum.to(rows.dtype), with lr and gsum rounded to T first
    // (the reference's weak-typed scalar) and the product too
    const float lr = to_f(from_f<T>(h.lr));
    for (int64_t c0 = 0; c0 < dim; c0 += CW) {
      load_row(c0);
      segment_sum<G, DPL>(s, grads, perm, beg, end, dim, c0, sub, mask);
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        const int64_t d = c0 + sub + k * G;
        if (d < dim) {
          table[row + d] =
              sub_step(old[k], __fmul_rn(lr, to_f(from_f<T>(s[k]))));
        }
      }
    }
  } else if (RULE == kAdagrad) {
    const float acc0 = st_a[id];
    load_row(0);
    const bool one_chunk = dim <= CW;
    float sq = 0.f;
    for (int64_t c0 = 0; c0 < dim; c0 += CW) {
      segment_sum<G, DPL>(s, grads, perm, beg, end, dim, c0, sub, mask);
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        if (c0 + sub + k * G < dim) sq = __fadd_rn(sq, __fmul_rn(s[k], s[k]));
      }
    }
    sq = group_sum<G>(sq, mask);
    const float acc = __fadd_rn(acc0, __fdiv_rn(sq, static_cast<float>(dim)));
    const float denom = __fsqrt_rn(__fadd_rn(acc, h.eps));
    for (int64_t c0 = 0; c0 < dim; c0 += CW) {
      if (!one_chunk) {  // rows wider than a chunk: walk the segment again
        load_row(c0);
        segment_sum<G, DPL>(s, grads, perm, beg, end, dim, c0, sub, mask);
      }
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        const int64_t d = c0 + sub + k * G;
        if (d < dim) {
          table[row + d] =
              sub_step(old[k], __fdiv_rn(__fmul_rn(h.lr, s[k]), denom));
        }
      }
    }
    __syncwarp(mask);  // every lane has read st_a[id] before lane 0 writes
    if (sub == 0) st_a[id] = acc;
  } else {
    const int32_t t = st_t[id] + 1;
    const float tf = static_cast<float>(t);
    const float bc1 = __fsub_rn(1.f, powf(h.b1, tf));
    const float bc2 = __fsub_rn(1.f, powf(h.b2, tf));
    for (int64_t c0 = 0; c0 < dim; c0 += CW) {
      float m0[DPL], v0[DPL];
      load_row(c0);
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        const int64_t d = c0 + sub + k * G;
        m0[k] = d < dim ? st_a[row + d] : 0.f;
        v0[k] = d < dim ? st_b[row + d] : 0.f;
      }
      segment_sum<G, DPL>(s, grads, perm, beg, end, dim, c0, sub, mask);
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        const int64_t d = c0 + sub + k * G;
        if (d < dim) {
          const float g = s[k];
          const float m =
              __fadd_rn(__fmul_rn(h.b1, m0[k]), __fmul_rn(h.omb1, g));
          const float v = __fadd_rn(__fmul_rn(h.b2, v0[k]),
                                    __fmul_rn(__fmul_rn(h.omb2, g), g));
          const float mhat = __fdiv_rn(m, bc1);
          const float vhat = __fdiv_rn(v, bc2);
          const float step = __fdiv_rn(__fmul_rn(h.lr, mhat),
                                       __fadd_rn(__fsqrt_rn(vhat), h.eps));
          st_a[row + d] = m;
          st_b[row + d] = v;
          table[row + d] = sub_step(old[k], step);
        }
      }
    }
    __syncwarp(mask);  // every lane has read st_t[id] before lane 0 writes
    if (sub == 0) st_t[id] = t;
  }
}

// Workers of G lanes walk the segment table, grid-stride: meta[0] segments.
template <int RULE, typename T, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks<G>)
    sparse_apply_kernel(T* __restrict__ table, float* __restrict__ st_a,
                        float* __restrict__ st_b, int32_t* __restrict__ st_t,
                        const float* __restrict__ grads,
                        const int32_t* __restrict__ perm,
                        const int32_t* __restrict__ seg_start,
                        const int32_t* __restrict__ seg_id,
                        const int32_t* __restrict__ meta, int64_t dim,
                        Hyper h) {
  ps::pdl_wait();  // the grouping pass has finished
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane & ~(G - 1));
  const int64_t workers = static_cast<int64_t>(gridDim.x) * (kThreads / G);
  const int64_t segs = meta[0];
  for (int64_t w = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) /
                   G;
       w < segs; w += workers) {
    const int64_t beg = seg_start[w], end = seg_start[w + 1];
    const int32_t id = seg_id[w];
    apply_segment<RULE, T, G>(table, st_a, st_b, st_t, grads, perm, beg, end,
                              id, dim, h, sub, mask);
  }
}

template <int RULE, typename T, int G>
cudaError_t launch(void* table, void* st_a, void* st_b, void* st_t,
                   const void* grads, const void* perm, const void* seg_start,
                   const void* seg_id, const void* meta, int64_t n,
                   int64_t dim, Hyper h, int device, cudaStream_t stream) {
  // enough workers for n segments (the most there can be), at most one
  // wave of 8 blocks an SM; the rest is the grid-stride loop
  const int64_t per_block = kThreads / G;
  int64_t blocks = (n + per_block - 1) / per_block;
  const int64_t wave = static_cast<int64_t>(ps::sm_count(device)) * 8;
  if (blocks > wave) blocks = wave;
  return ps::launch_pdl(
      sparse_apply_kernel<RULE, T, G>, dim3(static_cast<unsigned>(blocks)),
      dim3(kThreads), 0, stream, static_cast<T*>(table),
      static_cast<float*>(st_a), static_cast<float*>(st_b),
      static_cast<int32_t*>(st_t), static_cast<const float*>(grads),
      static_cast<const int32_t*>(perm),
      static_cast<const int32_t*>(seg_start),
      static_cast<const int32_t*>(seg_id), static_cast<const int32_t*>(meta),
      dim, h);
}

template <int RULE, typename T>
cudaError_t launch_width(void* table, void* st_a, void* st_b, void* st_t,
                         const void* grads, const void* perm,
                         const void* seg_start, const void* seg_id,
                         const void* meta, int64_t n, int64_t dim, Hyper h,
                         int device, cudaStream_t s) {
  if (dim == 1) {
    return launch<RULE, T, 1>(table, st_a, st_b, st_t, grads, perm, seg_start,
                              seg_id, meta, n, dim, h, device, s);
  }
  if (dim <= 16) {
    return launch<RULE, T, 16>(table, st_a, st_b, st_t, grads, perm,
                               seg_start, seg_id, meta, n, dim, h, device, s);
  }
  return launch<RULE, T, 32>(table, st_a, st_b, st_t, grads, perm, seg_start,
                             seg_id, meta, n, dim, h, device, s);
}

}  // namespace

extern "C" {

// rule: 0 sgd, 1 adagrad (st_a = acc [R]), 2 adam (st_a = m, st_b = v
// [R, D], st_t = t [R]); is_bf16 selects the table type (else f32).
// grads [n, dim] f32 in arrival order; perm [n], seg_start, seg_id and
// meta as csrc/sparse_group.cu writes them. Returns a CUDA error code
// (0 = launched).
int ps_sparse_apply(int rule, int is_bf16, void* table, void* st_a,
                    void* st_b, void* st_t, const void* grads,
                    const void* perm, const void* seg_start,
                    const void* seg_id, const void* meta, long long n,
                    long long dim, float lr, float b1, float b2, float omb1,
                    float omb2, float eps, int device, void* stream) {
  if (n <= 0) return 0;
  if (dim <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Hyper h{lr, b1, b2, omb1, omb2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PS_LAUNCH(R, T)                                                    \
  err = launch_width<R, T>(table, st_a, st_b, st_t, grads, perm, seg_start, \
                           seg_id, meta, n, dim, h, device, s)
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
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* ps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
