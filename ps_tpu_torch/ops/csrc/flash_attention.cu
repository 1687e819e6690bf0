// Flash attention forward: O = softmax(scale * Q K^T, masked) V and the
// log-sum-exp of every query row, by an online softmax over key tiles.
//
// Replaces the TPU kernel in ps_tpu/ops/flash_attention.py (_fwd_kernel,
// launched by _flash_fwd through pl.pallas_call at l.136). It is not that
// kernel carried over block by block. The Pallas grid (B*h, S/128, S/128)
// runs its key axis innermost and in order, carrying the running max, sum
// and accumulator in VMEM scratch from one grid step to the next. Hopper's
// blocks run in parallel and in no order, so here one block owns a tile of
// 64 query rows of one (batch, head) and walks every key tile itself: the
// scratch becomes registers, and each key tile's K and V are staged in
// shared memory. Two kernels, chosen by the inputs' type:
//
// - bf16 (the main path): tensor cores. Four warps own 16 query rows each.
//   Q K^T and P V are mma.sync m16n8k16 products of bf16 with f32 sums;
//   K and V tiles are read from shared memory with ldmatrix (V transposed
//   by ldmatrix.trans), rows padded so the reads are free of bank
//   conflicts. Each thread holds two rows' running max and a partial sum,
//   the 4 threads of a row agree on the max by shuffles, and the score
//   fragment is reused in registers as the A operand of P V.
// - f32: CUDA cores, one query row per thread, K and V tiles in shared
//   memory as f32 read by broadcast. Tensor cores would round f32 to tf32
//   and lose the f32 contract, so f32 stays on FMAs.
//
// Numerics kept from the reference, which the plain version
// (_flash_fwd_torch in ps_tpu_torch/ops/flash_attention.py) repeats:
// - the dot runs on the inputs' values with f32 sums and is scaled after;
// - masked scores are exactly -1e30 (not -inf), and p is gated by
//   s > -1e30 / 2 rather than trusted to exp, so a fully masked row keeps
//   m = -1e30 and l = 0, writes O = 0 through safe_l = 1 and
//   lse = -1e30 + log(1) = -1e30, which the backward's gate relies on;
// - p is rounded to V's type before it multiplies V (bf16 inputs), while
//   l sums the unrounded p;
// - row bh reads padding-mask row bh / heads; with causal, a key tile that
//   lies wholly past the block's last row is skipped and a live tile is
//   masked entry by entry.
// Keys are summed in this kernel's own order and the online update runs
// per tile of 64 keys (16 for f32), so it is not bitwise equal to the
// plain version.
//
// What bounds it. At BERT-base's shape on the main path (B*h = 384,
// S = 512, d = 64, bf16) the work is 4 * B*h * S^2 * d = 25.8 GFLOP, 0.026
// ms at the tensor cores' 989 TFLOP/s, and the bytes are q, k, v and O in
// bf16, lse in f32 and the mask, 101.5 MB, 0.030 ms at 3.35 TB/s: on paper
// the bytes bound it, by a hair. This design reaches neither: mma.sync
// runs at a fraction of wgmma's rate, each key tile is loaded with a
// synchronous copy and a barrier (no TMA, no double buffering), and every
// block re-reads its (batch, head)'s K and V from L2. Those are the next
// changes (wgmma with TMA-fed, double-buffered tiles).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's _NEG_INF

// -- bf16: tensor cores ----------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kBlockM = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kBlockN = 64;           // keys per shared-memory tile
constexpr int kPad = 8;               // bf16 of padding per smem row

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // p.astype(bf16)
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4): A holds
// (row g, cols 2t, 2t+1), (row g+8, same), (row g, cols 2t+8, 2t+9),
// (row g+8, same); B holds (rows 2t, 2t+1, col g), (rows 2t+8, 2t+9, col g);
// C holds (row g, cols 2t, 2t+1), (row g+8, same).
template <int D>
__global__ void __launch_bounds__(32 * kWarps)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const int32_t* __restrict__ mask,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int seq, int heads,
                          float scale, int causal) {
  constexpr int kStride = D + kPad;  // 16-byte rows on distinct banks
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockN * kStride];
  __shared__ int live[kBlockN];  // key in range and not padded

  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rows[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
  const int64_t base = static_cast<int64_t>(bh) * seq * D;
  const int32_t* mrow = mask + static_cast<int64_t>(bh / heads) * seq;

  // this warp's 16 query rows as A fragments, one per 16 columns of d
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rows[i % 2];
      const int col = kk * 16 + 2 * t + (i / 2) * 8;
      qf[kk][i] = row < seq ? *reinterpret_cast<const uint32_t*>(
                                  q + base + static_cast<int64_t>(row) * D + col)
                            : 0u;
    }
  }
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  for (int k0 = 0; k0 < seq; k0 += kBlockN) {
    // causal: a tile wholly past the block's last row adds nothing
    if (causal && k0 > row0 + kBlockM - 1) break;
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < kBlockN * D / 8; i += 32 * kWarps) {
      const int key = i / (D / 8);
      const int col = (i % (D / 8)) * 8;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = kx;
      if (k0 + key < seq) {
        const int64_t at = base + static_cast<int64_t>(k0 + key) * D + col;
        kx = *reinterpret_cast<const uint4*>(k + at);
        vx = *reinterpret_cast<const uint4*>(v + at);
      }
      *reinterpret_cast<uint4*>(ks + key * kStride + col) = kx;
      *reinterpret_cast<uint4*>(vs + key * kStride + col) = vx;
    }
    for (int j = threadIdx.x; j < kBlockN; j += 32 * kWarps) {
      live[j] = k0 + j < seq && mrow[k0 + j] > 0;
    }
    __syncthreads();

    // S = Q K^T for this warp's rows: kBlockN / 8 tiles of 8 keys
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; nt += 2) {
        // matrices: keys of tile nt and nt+1 x cols kk*16 and kk*16+8
        const int mi = lane / 8;
        const int key = (nt + mi / 2) * 8 + lane % 8;
        uint32_t b[4];
        ldmatrix_x4(b, ks + key * kStride + kk * 16 + (mi % 2) * 8);
        mma_bf16(s[nt], qf[kk], b[0], b[1]);
        mma_bf16(s[nt + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale, mask, and the online softmax of rows g and g+8
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nt * 8 + 2 * t + i % 2;
        float x = __fmul_rn(s[nt][i], scale);
        if (!live[col] || (causal && k0 + col > rows[i / 2])) x = kNegInf;
        s[nt][i] = x;
        mx[i / 2] = fmaxf(mx[i / 2], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // gate, don't trust exp: on a fully masked row m is -1e30 itself,
        // and exp(s - m) would be 1 for masked entries
        const float p =
            s[nt][i] > kNegInf / 2 ? expf(s[nt][i] - m[i / 2]) : 0.f;
        s[nt][i] = p;
        psum[i / 2] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[dt][i] *= alpha[i / 2];
    }

    // O += P V: the score fragments are P's A fragments, rounded to bf16
#pragma unroll
    for (int j = 0; j < kBlockN / 16; ++j) {
      const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                             pack_bf16(s[2 * j][2], s[2 * j][3]),
                             pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        // matrices: keys j*16 and j*16+8 x cols of tile dt and dt+1,
        // transposed so each thread holds two keys of one column
        const int mi = lane / 8;
        const int key = j * 16 + (mi % 2) * 8 + lane % 8;
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + key * kStride + (dt + mi / 2) * 8);
        mma_bf16(acc[dt], a, b[0], b[1]);
        mma_bf16(acc[dt + 1], a, b[2], b[3]);
      }
    }
  }

  float safe_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    // fully masked rows have l == 0: zeros, not NaN
    safe_l[r] = l[r] > 0.f ? l[r] : 1.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= seq) continue;
    __nv_bfloat16* orow = o + base + static_cast<int64_t>(rows[r]) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2 * r] / safe_l[r], acc[dt][2 * r + 1] / safe_l[r]);
    }
    if (t == 0) {
      lse[static_cast<int64_t>(bh) * seq + rows[r]] = m[r] + logf(safe_l[r]);
    }
  }
}

// -- f32: CUDA cores -------------------------------------------------------------

constexpr int kF32BlockM = 64;  // query rows per block, one per thread
constexpr int kF32BlockN = 64;  // keys per shared-memory tile
constexpr int kF32Chunk = 16;   // keys per online-softmax update

template <int D>
__global__ void __launch_bounds__(kF32BlockM)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int32_t* __restrict__ mask,
                         float* __restrict__ o, float* __restrict__ lse,
                         int seq, int heads, float scale, int causal) {
  __shared__ __align__(16) float ks[kF32BlockN * D];
  __shared__ __align__(16) float vs[kF32BlockN * D];
  __shared__ int live[kF32BlockN];

  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kF32BlockM;
  const int tid = threadIdx.x;
  const int row = row0 + tid;
  const int64_t base = static_cast<int64_t>(bh) * seq * D;
  const int32_t* mrow = mask + static_cast<int64_t>(bh / heads) * seq;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row < seq ? q[base + static_cast<int64_t>(row) * D + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  for (int k0 = 0; k0 < seq; k0 += kF32BlockN) {
    if (causal && k0 > row0 + kF32BlockM - 1) break;
    __syncthreads();
    for (int i = tid; i < kF32BlockN * D; i += kF32BlockM) {
      const int key = k0 + i / D;
      const int64_t at = base + static_cast<int64_t>(k0) * D + i;
      ks[i] = key < seq ? k[at] : 0.f;
      vs[i] = key < seq ? v[at] : 0.f;
    }
    for (int j = tid; j < kF32BlockN; j += kF32BlockM) {
      live[j] = k0 + j < seq && mrow[k0 + j] > 0;
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < kF32BlockN; c += kF32Chunk) {
      float s[kF32Chunk];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kF32Chunk; ++j) {
        const float4* kr = reinterpret_cast<const float4*>(ks + (c + j) * D);
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 kk = kr[d4];
          dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
          dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
          dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
          dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
        }
        float sj = __fmul_rn(dot, scale);
        if (!live[c + j] || (causal && k0 + c + j > row)) sj = kNegInf;
        s[j] = sj;
        mx = fmaxf(mx, sj);
      }
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kF32Chunk; ++j) {
        const float p = s[j] > kNegInf / 2 ? expf(s[j] - m_new) : 0.f;
        psum += p;
        const float4* vr = reinterpret_cast<const float4*>(vs + (c + j) * D);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
      l = l * alpha + psum;
      m = m_new;
    }
  }

  if (row < seq) {
    const float safe_l = l > 0.f ? l : 1.f;
    float* orow = o + base + static_cast<int64_t>(row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = acc[d] / safe_l;
    lse[static_cast<int64_t>(bh) * seq + row] = m + logf(safe_l);
  }
}

template <int D>
void launch(int is_bf16, const void* q, const void* k, const void* v,
            const void* mask, void* o, void* lse, int bh, int seq, int heads,
            float scale, int causal, cudaStream_t stream) {
  if (is_bf16) {
    const dim3 grid((seq + kBlockM - 1) / kBlockM, bh);
    flash_fwd_bf16_kernel<D><<<grid, 32 * kWarps, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const int32_t*>(mask), static_cast<__nv_bfloat16*>(o),
        static_cast<float*>(lse), seq, heads, scale, causal);
  } else {
    const dim3 grid((seq + kF32BlockM - 1) / kF32BlockM, bh);
    flash_fwd_f32_kernel<D><<<grid, kF32BlockM, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int32_t*>(mask),
        static_cast<float*>(o), static_cast<float*>(lse), seq, heads, scale,
        causal);
  }
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous [bh, seq, head_dim], bf16 if is_bf16 else f32;
// mask: contiguous [bh / heads, seq] int32 (1 = attend); lse: [bh, seq]
// f32. head_dim is 16, 32 or 64. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError().
int ps_flash_attention_fwd(int is_bf16, int head_dim, const void* q,
                           const void* k, const void* v, const void* mask,
                           void* o, void* lse, long long bh, long long seq,
                           long long heads, float scale, int causal,
                           int device, void* stream) {
  if (bh <= 0 || seq <= 0) return 0;
  if (bh > 65535 || seq > (1LL << 30) || heads <= 0 || bh % heads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PS_LAUNCH(D)                                                        \
  launch<D>(is_bf16, q, k, v, mask, o, lse, static_cast<int>(bh),            \
            static_cast<int>(seq), static_cast<int>(heads), scale, causal, s)
  if (head_dim == 16) PS_LAUNCH(16);
  else if (head_dim == 32) PS_LAUNCH(32);
  else if (head_dim == 64) PS_LAUNCH(64);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef PS_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

const char* ps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
