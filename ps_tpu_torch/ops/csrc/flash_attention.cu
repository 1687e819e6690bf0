// Flash attention forward: O = softmax(scale * Q K^T, masked) V and the
// log-sum-exp of every query row, by an online softmax over key tiles.
//
// Replaces the TPU kernel in ps_tpu/ops/flash_attention.py (_fwd_kernel,
// launched by _flash_fwd through pl.pallas_call at l.136). It is not that
// kernel carried over block by block. The Pallas grid (B*h, S/128, S/128)
// runs its key axis innermost and in order, carrying the running max, sum
// and accumulator in VMEM scratch from one grid step to the next. Hopper's
// blocks run in parallel and in no order, so here one block owns a tile of
// query rows of one (batch, head) and walks every key tile itself: the
// scratch becomes registers. Two kernels, chosen by the inputs' type:
//
// - bf16 (the main path): Hopper's units, one template on the head width
//   D in {16, 32, 64}. A persistent grid, one block of 384 threads per SM,
//   walks the work items (128 query rows of one (batch, head)). Two
//   consumer warpgroups own 64 rows each (wgmma's M); the third
//   warpgroup is the producer, one of its warps issuing every load, and
//   setmaxnreg hands its registers to the consumers. The producer loads
//   each item's Q (two buffers, so the next item's Q loads while this one
//   runs) and streams K and V through a ring of three stages of 128-key
//   tiles by TMA, from 3-D tensor maps [B*h, S, D] (a tile past a head's
//   end is zero-filled, never the next head's rows), swizzled to the row
//   width (128/64/32 bytes for D = 64/32/16). Full and empty mbarriers
//   order the ring. Each consumer computes S = Q K^T with wgmma
//   m64n128k16 (Q and K from shared memory, both K-major), runs the online
//   softmax on the accumulator fragments, packs P to bf16 in place and
//   computes O += P V with wgmma m64nDk16, P from registers and V from
//   shared memory (MN-major, the B-transpose bit).
// - f32: exact f32 FMAs on the CUDA cores, one template on D as well. A
//   block of 256 threads owns two items of one (batch, head), 128 query
//   rows each, and walks their 64-key tiles: with causal, query tiles i
//   and n - 1 - i, so that every block walks the same number of key
//   tiles (the longer item first); without, tiles 2i and 2i + 1. Q is
//   staged once per item (two buffers); K, V and the tile's mask entries
//   stream through a ring of three stages filled by cp.async, rows past
//   a head's end zero-filled, so the next two tiles (and the second
//   item's Q) load while this one computes. Thread (r, g), r = tid / 8
//   and g = tid % 8, computes a 4 x 8 register tile of S (rows r + 32i,
//   keys g + 8j) and owns the same 4 rows of O over D / 8 columns; the 8
//   threads of a row are 8 lanes of one warp, so its max and sum are warp
//   shuffles. P goes through shared memory transposed, one 16-byte read a
//   key giving a thread its 4 rows; a warp writes and reads only its own
//   rows of it, so a __syncwarp orders them. Rows of Q, K, V and P^T
//   carry 16 bytes of padding, which puts the 16-byte chunks a warp reads
//   at one time in distinct banks.
//
// Numerics kept from the reference, which the plain version
// (_flash_fwd_torch in ps_tpu_torch/ops/flash_attention.py) repeats:
// - the dot runs on the inputs' values with f32 sums and is scaled after;
// - masked scores are exactly -1e30 (not -inf), and p is gated by
//   s > -1e30 / 2 rather than trusted to exp, so a fully masked row keeps
//   m = -1e30 and l = 0, writes O = 0 through safe_l = 1 and
//   lse = -1e30 + log(1) = -1e30, which the backward's gate relies on;
//   log2(e) is folded into exp2 only after that gate, and m and lse stay
//   in natural-log units (exp2 flushes results below 2^-126 to 0);
// - p is rounded to V's type before it multiplies V (bf16 inputs), while
//   l sums the unrounded p;
// - row bh reads padding-mask row bh / heads; with causal, a key tile that
//   lies wholly past the block's last row is skipped and the live tile on
//   the diagonal is masked entry by entry.
// Keys are summed in this kernel's own order and the online update runs
// per tile of 128 keys (64 for f32), so it is not bitwise equal to the
// plain version; it is bitwise equal to itself from run to run (no
// atomics, no order that depends on scheduling).
//
// What bounds it. At BERT-base's shape on the main path (B*h = 384,
// S = 512, d = 64, bf16) the work is 4 * B*h * S^2 * d = 25.8 GFLOP, 0.026
// ms at the tensor cores' 989 TFLOP/s, and the bytes are q, k, v and O in
// bf16, lse in f32 and the mask, 101.5 MB, 0.030 ms at 3.35 TB/s: on paper
// the bytes bound it, by a hair. In practice neither does. The products
// and loads alone (the softmax left out) take about twice the bound, and
// the softmax on the CUDA cores adds as much again: per score a scale, a
// max, an FMA, an exp2 on the 16-per-clock special-function unit and a
// sum, against a 64-deep dot product on the tensor cores, with each
// warpgroup waiting for its own products between steps (PERF.md). What
// this design does about the four limits of the mma.sync design it
// replaces:
// 1. products on mma.sync m16n8k16 -> wgmma, the only way to the tensor
//    cores' full rate;
// 2. synchronous K/V tiles loaded by every thread between two barriers ->
//    TMA into a three-stage ring, issued by one producer thread, so later
//    tiles' loads (the next item's too) overlap this tile's products and
//    softmax;
// 3. 64 query rows per block, each head's K/V read 8 times from L2, and a
//    block's start-up exposed at every one of 3,072 blocks -> 128 rows
//    per item (K/V read 4 times at S = 512), one persistent block per SM
//    with 129 KB of shared memory and 256 consumer threads at up to 232
//    registers each;
// 4. a shared-memory mask lookup and a causal compare per score, exp in
//    natural units -> the producer turns each tile's 128 mask entries into
//    four 32-bit words by ballot; a tile with every key live and off the
//    diagonal skips the mask work; exp2 with log2(e) folded into one FMA
//    after the gate; the gate's compare itself is skipped where no row of
//    the warp is near -1e30 (the result is the same, see online_softmax),
//    the rescale of O where no row's max moved, and the epilogue
//    multiplies by 1 / l.
//
// What bounds the f32 kernel. At the causal LM's shape (B*h = 16, S =
// 2048, d = 64) the work is 4 * 16 * (2048 * 2049 / 2) * 64 = 8.59 GFLOP,
// 0.128 ms at the CUDA cores' 67 TFLOP/s, and the bytes are q, k, v and O
// in f32, lse and the mask, 33.7 MB, 0.010 ms at 3.35 TB/s: the FMAs bound
// it, by 13x. f32 stays off the tensor cores: they take f32 only as tf32
// (a 10-bit mantissa; three tf32 products win back most, not all, of
// f32), while the contract, which the reference and the plain version
// keep, is exact f32 products, and the bound divides by the FMA peak,
// which a tensor-core kernel could read above 100% of. Each score's dot
// runs over d in order, one FMA at a time, and is scaled after. What this
// design does about the five limits of the one-row-per-thread design it
// replaces:
// 1. one query row per thread (64 of q and 64 of O in registers), 2 warps
//    a block -> a 4 x 8 tile of S and 4 rows x D / 8 of O a thread: 32
//    independent sums in flight each, 8 warps an SM;
// 2. one 16-byte shared load per 4 FMAs (K by broadcast) -> 12 loads per
//    128 FMAs in Q K^T (4 of Q, 8 of K a step of 4 along d) and 3 per 32
//    in P V (P's 4 rows, 8 of V's columns), the padded rows putting the
//    chunks a warp reads at one time in distinct banks;
// 3. K and V loaded by every thread between two barriers, nothing
//    overlapping -> cp.async into a three-stage ring, one barrier a tile;
// 4. expf per score and an online update per 16 keys -> one update per
//    64-key tile, exp2 with log2(e) folded into one FMA after the gate;
//    the mask work skipped on a tile whose keys are all live and which
//    lies off the diagonal, and the gate's compare where no row of the
//    warp is near -1e30;
// 5. a causal grid (S / 64, B*h) whose blocks walk 1 to 32 key tiles ->
//    query tiles i and n - 1 - i in one block: at the LM's shape 8 pairs
//    x 16 heads = 128 blocks on 132 SMs, 34 tiles each.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// -- bf16: wgmma on TMA-fed tiles ------------------------------------------------

constexpr int kBlockM = 128;  // query rows per block
constexpr int kBlockN = 128;  // keys per K/V tile
constexpr int kStages = 3;    // K/V ring depth
constexpr int kConsumers = kBlockM / 64;        // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
// registers per thread after the split: the producer warpgroup gives up
// what the consumers take (40 * 128 + 232 * 256 <= 65,536)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// Shared memory of one block, in bytes from a 1024-aligned base: two Q
// buffers, the K and V rings (each tile [rows, D] bf16 as TMA swizzles
// it), the mbarriers and each stage's four words of live-key bits.
template <int D>
struct Smem {
  static constexpr int kTileQ = kBlockM * D * 2;
  static constexpr int kTile = kBlockN * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + 2 * kTileQ;
  static constexpr int kV = kK + kStages * kTile;
  // q_full[2], q_empty[2], full_k[kStages], full_v[kStages], empty[kStages]
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kLive = kBar + 8 * (4 + 3 * kStages);
  static constexpr int kBytes = kLive + 16 * kStages;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// arrive once and expect `bytes` more from TMA before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one [box] tile of a 3-D tensor map at (c0, c1, c2) into shared memory,
// reported to `bar` as transaction bytes
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from touching registers that an in-flight wgmma owns
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// wgmma's shared-memory matrix descriptor for a tile of rows D * 2 bytes
// wide, as TMA writes it with the swizzle of that width: start address,
// leading offset 1 (unused: one swizzle atom spans the operand's K, or its
// N when transposed), stride 8 rows = D * 16 bytes = D units of 16 bytes,
// and the swizzle mode (1 = 128 B, 2 = 64 B, 3 = 32 B).
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t kMode = D == 64 ? 1 : (D == 32 ? 2 : 3);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(D) << 32) | (kMode << 62);
}

// 2^x on the special-function unit, subnormal results flushed to zero
// (below 1.2e-38, against a row sum of at least 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // p.astype(bf16)
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 128) += A (64 x 16) B (16 x 128); A and B in shared memory, both
// K-major; the sum is skipped (d = A B) when accumulate is 0
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 16) += A (64 x 16) B (16 x 16); A in registers, B in shared
// memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32) += A (64 x 16) B (16 x 32); A in registers, B in shared
// memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64) += A (64 x 16) B (16 x 64); A in registers, B in shared
// memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 64) {
    wgmma_rs_n64(d, a, b);
  } else if constexpr (D == 32) {
    wgmma_rs_n32(d, a, b);
  } else {
    wgmma_rs_n16(d, a, b);
  }
}

// The online-softmax update of one 64 x 128 score tile (this thread's 64
// entries, two rows): scale and mask s in place, the rows' new max m, the
// factor alpha that rescales what was summed before, p in s and l.
// Fragment of the wgmma accumulator (warp w of the warpgroup, g = lane /
// 4, t = lane % 4): s[4j + e] is row 16w + g + 8 (e / 2), column
// 8j + 2t + e % 2. Dead keys and, on the diagonal tile, keys past the row
// become exactly -1e30; a tile whose keys are all live and which is not on
// the diagonal skips that work.
template <bool kMasked>
__device__ __forceinline__ void scale_mask_max(float (&s)[64], float (&mx)[2],
                                               float scale,
                                               const uint32_t (&live)[4],
                                               bool diag, int key0,
                                               const int (&rows)[2]) {
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = __fmul_rn(s[4 * j + e], scale);
      if (kMasked) {
        // live[w] holds keys 32w.. shifted right by 2t: key 8j + 2t + e % 2
        // is bit 8 (j % 4) + e % 2 of word j / 4
        const bool dead = !((live[j / 4] >> (8 * (j % 4) + e % 2)) & 1u);
        if (dead || (diag && key0 + 8 * j + e % 2 > rows[e / 2])) x = kNegInf;
      }
      s[4 * j + e] = x;
      mx[e / 2] = fmaxf(mx[e / 2], x);
    }
  }
}

__device__ __forceinline__ void online_softmax(
    float (&s)[64], float (&m)[2], float (&l)[2], float (&alpha)[2],
    float scale, const uint32_t* words, bool diag, int k0,
    const int (&rows)[2]) {
  const int t = threadIdx.x % 4;
  uint32_t live[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) live[w] = words[w] >> (2 * t);
  float mx[2] = {kNegInf, kNegInf};
  if (!diag && (words[0] & words[1] & words[2] & words[3]) == 0xffffffffu) {
    scale_mask_max<false>(s, mx, scale, live, diag, k0 + 2 * t, rows);
  } else {
    scale_mask_max<true>(s, mx, scale, live, diag, k0 + 2 * t, rows);
  }
  float m_log2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = exp2_ftz((m[r] - m_new) * kLog2e);
    m[r] = m_new;
    m_log2[r] = m_new * kLog2e;
  }
  float psum[2] = {0.f, 0.f};
  // Gate, don't trust exp: on a fully masked row m is -1e30 itself, and
  // exp(s - m) would be 1 for masked entries. Where every row of the warp
  // has m > -1e30 / 4, an entry the gate zeroes (s <= -1e30 / 2) has
  // (s - m) log2(e) < -3.6e29 and exp2 gives exactly 0 as well, so the
  // gate's compare and select are skipped with the same result.
  if (__all_sync(0xffffffffu, m[0] > kNegInf / 4 && m[1] > kNegInf / 4)) {
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      s[j] = exp2_ftz(fmaf(s[j], kLog2e, -m_log2[(j % 4) / 2]));
      psum[(j % 4) / 2] += s[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      s[j] = s[j] > kNegInf / 2
                 ? exp2_ftz(fmaf(s[j], kLog2e, -m_log2[(j % 4) / 2]))
                 : 0.f;
      psum[(j % 4) / 2] += s[j];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
}

// P's A fragments for the 8 steps of 16 keys of P V: the score fragments
// themselves, rounded to bf16
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&pa)[kBlockN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    }
  }
}

// Persistent: one block per SM walks the work items blockIdx.x,
// + gridDim.x, ... of (query tile, batch*head). Warp roles: warps 0-7 are
// two consumer warpgroups (rows 0-63 and 64-127 of an item's tile), warps
// 8-11 the producer warpgroup, of which warp 8 issues the loads. The
// roles split once and never meet again: after the split they sync only
// through mbarriers, and setmaxnreg moves the producer's registers to the
// consumers. The producer runs ahead across items: the next item's Q (two
// buffers) and first K/V tiles load while the consumers finish this one.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const int32_t* __restrict__ mask,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int seq, int heads,
                          int bh_count, float scale, int causal) {
  using L = Smem<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms are 1 KB
  uint32_t* live_words = reinterpret_cast<uint32_t*>(smem_raw + (base - raw) +
                                                     L::kLive);
  auto q_tile = [&](int b) { return base + L::kQ + b * L::kTileQ; };
  auto k_tile = [&](int s) { return base + L::kK + s * L::kTile; };
  auto v_tile = [&](int s) { return base + L::kV + s * L::kTile; };
  auto q_full = [&](int b) { return base + L::kBar + 8 * b; };
  auto q_empty = [&](int b) { return base + L::kBar + 8 * (2 + b); };
  auto full_k = [&](int s) { return base + L::kBar + 8 * (4 + s); };
  auto full_v = [&](int s) {
    return base + L::kBar + 8 * (4 + kStages + s);
  };
  auto empty = [&](int s) {
    return base + L::kBar + 8 * (4 + 2 * kStages + s);
  };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q_tiles = (seq + kBlockM - 1) / kBlockM;
  const int items = q_tiles * bh_count;
  // item -> (batch*head, first query row). Query tile fastest, so blocks
  // working at one time share K and V in L2; with causal, the tiles with
  // the most keys first instead (in a fixed order every query tile would
  // always land on the same blocks, whose loads differ up to S / 128
  // times)
  auto item = [&](int it, int& bh, int& row0) {
    if (causal) {
      bh = it % bh_count;
      row0 = (q_tiles - 1 - it / bh_count) * kBlockM;
    } else {
      bh = it / q_tiles;
      row0 = (it % q_tiles) * kBlockM;
    }
  };
  // key tiles of the item whose query tile starts at row0; causal: a tile
  // wholly past the tile's last row adds nothing
  auto key_tiles = [&](int row0) {
    const int n = (seq + kBlockN - 1) / kBlockN;
    return causal ? min(n, (row0 + kBlockM - 1) / kBlockN + 1) : n;
  };

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full(b), 1);
      mbar_init(q_empty(b), 128 * kConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // -- producer: per item Q, then K and V tiles through the ring ---------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp > 4 * kConsumers) return;  // one warp issues the loads
    int c = 0;  // K/V tiles loaded so far, over all items
    int j = 0;  // items so far
    for (int it = blockIdx.x; it < items; it += gridDim.x, ++j) {
      int bh, row0;
      item(it, bh, row0);
      const int b = j % 2;
      mbar_wait(q_empty(b), ((j / 2) & 1) ^ 1);  // first round: free
      if (lane == 0) {
        mbar_expect_tx(q_full(b), L::kTileQ);
        tma_load_3d(q_tile(b), &tq, q_full(b), 0, row0, bh);
      }
      const int32_t* mrow = mask + static_cast<int64_t>(bh / heads) * seq;
      const int n_tiles = key_tiles(row0);
      for (int i = 0; i < n_tiles; ++i, ++c) {
        const int s = c % kStages;
        mbar_wait(empty(s), ((c / kStages) & 1) ^ 1);
        const int k0 = i * kBlockN;
        uint32_t words[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int key = k0 + 32 * w + lane;
          words[w] = __ballot_sync(0xffffffffu, key < seq && mrow[key] > 0);
        }
        if (lane == 0) {
#pragma unroll
          for (int w = 0; w < 4; ++w) live_words[4 * s + w] = words[w];
          // the arrive releases the words above to the consumers' wait
          mbar_expect_tx(full_k(s), L::kTile);
          tma_load_3d(k_tile(s), &tk, full_k(s), 0, k0, bh);
          mbar_expect_tx(full_v(s), L::kTile);
          tma_load_3d(v_tile(s), &tv, full_v(s), 0, k0, bh);
        }
        __syncwarp();
      }
    }
    return;
  }

  // -- consumers: 64 query rows per warpgroup ------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4;
  const int g = lane / 4;
  const int t = lane % 4;
  int c = 0;
  int j = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++j) {
    int bh, row0;
    item(it, bh, row0);
    const int n_tiles = key_tiles(row0);
    const int rows[2] = {row0 + 64 * wg + 16 * (warp % 4) + g,
                         row0 + 64 * wg + 16 * (warp % 4) + g + 8};
    const int b = j % 2;
    const uint32_t q_wg = q_tile(b) + 64 * wg * D * 2;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's share of each row's sum
    float alpha[2];
    uint32_t pa[kBlockN / 16][4];

    // S = Q K^T: D / 16 steps of 16 along the head width (32 bytes)
    auto qk = [&](int st) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss_n128(s, smem_desc<D>(q_wg + 32 * kk),
                      smem_desc<D>(k_tile(st) + 32 * kk), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V: 8 steps of 16 keys, each 16 rows of V further on
    auto pv = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        wgmma_pv<D>(acc, pa[kk], smem_desc<D>(v_tile(st) + kk * 16 * D * 2));
      }
      wgmma_commit();
    };

    mbar_wait(q_full(b), (j / 2) & 1);
    for (int i = 0; i < n_tiles; ++i, ++c) {
      const int st = c % kStages;
      const uint32_t parity = (c / kStages) & 1;
      mbar_wait(full_k(st), parity);
      pin(s);
      qk(st);
      wgmma_wait<0>();
      pin(s);
      if (i == n_tiles - 1) mbar_arrive(q_empty(b));
      online_softmax(s, m, l, alpha, scale, live_words + 4 * st,
                     causal && i * kBlockN + kBlockN - 1 > row0,
                     i * kBlockN, rows);
      // rescale the sums unless no row's max moved (alpha == 1 is exact)
      if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
        for (int x = 0; x < D / 2; ++x) acc[x] *= alpha[(x % 4) / 2];
      }
      pack_p(s, pa);
      mbar_wait(full_v(st), parity);
      pin(acc);
      pin(pa);
      wgmma_fence();
      pv(st);
      wgmma_wait<0>();
      pin(acc);
      pin(pa);
      mbar_arrive(empty(st));  // this thread no longer reads the stage
    }

    float safe_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      // fully masked rows have l == 0: zeros, not NaN
      safe_l[r] = l[r] > 0.f ? l[r] : 1.f;
    }
    // O = acc / safe_l as a product with the rounded reciprocal: within an
    // f32 ulp of the quotient before the bf16 rounding, and exact (0) on
    // rows that attend nothing
    const float inv_l[2] = {__frcp_rn(safe_l[0]), __frcp_rn(safe_l[1])};
    const int64_t head = static_cast<int64_t>(bh) * seq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= seq) continue;
      __nv_bfloat16* orow = o + (head + rows[r]) * D;
#pragma unroll
      for (int x = 0; x < D / 8; ++x) {
        *reinterpret_cast<uint32_t*>(orow + 8 * x + 2 * t) =
            pack_bf16(acc[4 * x + 2 * r] * inv_l[r],
                      acc[4 * x + 2 * r + 1] * inv_l[r]);
      }
      if (t == 0) lse[head + rows[r]] = m[r] + logf(safe_l[r]);
    }
  }
}

// -- f32: CUDA cores -------------------------------------------------------------

constexpr int kF32M = 128;        // query rows per item
constexpr int kF32N = 64;         // keys per K/V tile
constexpr int kF32Threads = 256;  // 32 row groups x 8 key groups
constexpr int kF32Stages = 3;     // K/V ring depth

// Shared memory of one f32 block, in floats: two Q buffers (the block's
// two items), the K and V rings, P transposed ([key][query slot], a
// thread's 4 rows in one 16-byte chunk) and each stage's mask entries.
// Rows of Q, K and V are D + 4 floats, P^T's 128 + 4: 16-byte chunk c of
// row x lies in bank group (x * (D / 4 + 1) + c) % 8, so the rows a warp
// reads at one time (8 consecutive keys, 4 consecutive query rows or
// slots) fall in distinct banks, for D = 16 too (5 is odd).
template <int D>
struct F32Smem {
  static constexpr int kRow = D + 4;
  static constexpr int kPRow = kF32M + 4;
  static constexpr int kTileQ = kF32M * kRow;
  static constexpr int kTile = kF32N * kRow;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + 2 * kTileQ;
  static constexpr int kV = kK + kF32Stages * kTile;
  static constexpr int kP = kV + kF32Stages * kTile;
  static constexpr int kMask = kP + kF32N * kPRow;
  static constexpr int kBytes = 4 * (kMask + kF32Stages * kF32N);
};

// 16 (or 4) bytes from global to shared memory, asynchronously; the
// bytes past `src_bytes` are zero-filled (src_bytes 0: all of them)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The D / 8 columns of O that key group g owns in a row: 16-byte chunks g
// and g + 8 (D = 64), chunk g (D = 32), or the 8 bytes at 2g (D = 16), so
// the 8 key groups of a warp touch one row's D floats at once, in
// distinct banks
template <int D>
__device__ __forceinline__ void f32_load_cols(const float* row, int g,
                                              float (&x)[D / 8]) {
  if constexpr (D == 16) {
    const float2 a = *reinterpret_cast<const float2*>(row + 2 * g);
    x[0] = a.x;
    x[1] = a.y;
  } else {
#pragma unroll
    for (int u = 0; u < D / 32; ++u) {
      const float4 a = *reinterpret_cast<const float4*>(row + 32 * u + 4 * g);
      x[4 * u + 0] = a.x;
      x[4 * u + 1] = a.y;
      x[4 * u + 2] = a.z;
      x[4 * u + 3] = a.w;
    }
  }
}

template <int D>
__device__ __forceinline__ void f32_store_cols(float* row, int g,
                                               const float (&x)[D / 8]) {
  if constexpr (D == 16) {
    *reinterpret_cast<float2*>(row + 2 * g) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int u = 0; u < D / 32; ++u) {
      *reinterpret_cast<float4*>(row + 32 * u + 4 * g) =
          make_float4(x[4 * u], x[4 * u + 1], x[4 * u + 2], x[4 * u + 3]);
    }
  }
}

// an item's running max, sum and O before its first tile
template <int D>
__device__ __forceinline__ void f32_reset(float (&acc)[4][D / 8], float (&m)[4],
                                          float (&l)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;
  }
}

// p = exp(s - m) of this thread's 4 x 8 scores in place, gated by
// s > -1e30 / 2 where kGate, with their sums into l and the rescale of
// what l and acc summed before by alpha
template <bool kGate, int D>
__device__ __forceinline__ void f32_exp_rows(float (&s)[4][8],
                                             const float (&m_log2)[4],
                                             const float (&alpha)[4],
                                             float (&l)[4],
                                             float (&acc)[4][D / 8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p = exp2_ftz(fmaf(s[i][j], kLog2e, -m_log2[i]));
      if (kGate && !(s[i][j] > kNegInf / 2)) p = 0.f;
      s[i][j] = p;
      psum += p;
    }
    l[i] = l[i] * alpha[i] + psum;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] *= alpha[i];
  }
}

// One block: the items (query tiles of 128 rows) tile0 and, if there is
// one, tile1 of batch*head blockIdx.y. Steps run over the items' key
// tiles in order, item 0's first; step t's K, V and mask sit in stage
// t % kF32Stages, loaded kF32Stages - 1 steps ahead, and an item's Q is
// loaded with its first step's tiles.
template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int32_t* __restrict__ mask,
                         float* __restrict__ o, float* __restrict__ lse,
                         int seq, int heads, float scale, int causal) {
  using L = F32Smem<D>;
  // the tiles' 16-byte chunks split evenly over the threads
  static_assert((kF32N * D / 4) % kF32Threads == 0, "tile chunks");
  extern __shared__ __align__(16) float fsm[];
  const uint32_t sbase = smem_u32(fsm);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = tid % 8;   // key group: keys g + 8j, O columns f32_load_cols
  const int rg = tid / 8;  // row group: rows rg + 32i of an item
  const int bh = blockIdx.y;
  const int64_t head = static_cast<int64_t>(bh) * seq;
  const float* qh = q + head * D;
  const float* kh = k + head * D;
  const float* vh = v + head * D;
  const int32_t* mrow = mask + static_cast<int64_t>(bh / heads) * seq;

  const int q_tiles = (seq + kF32M - 1) / kF32M;
  const int k_tiles = (seq + kF32N - 1) / kF32N;
  const int x = blockIdx.x;
  const int tile0 = causal ? q_tiles - 1 - x : 2 * x;
  const int tile1 = causal ? x : 2 * x + 1;
  const bool two = causal ? tile1 < tile0 : tile1 < q_tiles;
  // key tiles of an item; causal: a tile wholly past its last row adds
  // nothing
  auto key_tiles = [&](int tile) {
    return causal ? min(k_tiles, (tile * kF32M + kF32M - 1) / kF32N + 1)
                  : k_tiles;
  };
  const int n0 = key_tiles(tile0);
  const int steps = n0 + (two ? key_tiles(tile1) : 0);

  auto load = [&](int t) {
    if (t < steps) {
      const int it = t < n0 ? 0 : 1;
      const int kt = it ? t - n0 : t;
      const int st = t % kF32Stages;
      if (kt == 0) {  // the item's Q, rows past the head's end zero
        const int row0 = (it ? tile1 : tile0) * kF32M;
        const uint32_t dq = sbase + 4 * (L::kQ + it * L::kTileQ);
#pragma unroll
        for (int u = 0; u < kF32M * D / 4 / kF32Threads; ++u) {
          const int c = tid + u * kF32Threads;
          const int r = c / (D / 4), w = c % (D / 4);
          const bool in = row0 + r < seq;
          cp_async16(dq + 4 * (r * L::kRow + 4 * w),
                     qh + static_cast<int64_t>(in ? row0 + r : 0) * D + 4 * w,
                     in ? 16 : 0);
        }
      }
      const int k0 = kt * kF32N;
      const uint32_t dk = sbase + 4 * (L::kK + st * L::kTile);
      const uint32_t dv = sbase + 4 * (L::kV + st * L::kTile);
#pragma unroll
      for (int u = 0; u < kF32N * D / 4 / kF32Threads; ++u) {
        const int c = tid + u * kF32Threads;
        const int r = c / (D / 4), w = c % (D / 4);
        const bool in = k0 + r < seq;
        const int64_t at = static_cast<int64_t>(in ? k0 + r : 0) * D + 4 * w;
        const uint32_t off = 4 * (r * L::kRow + 4 * w);
        cp_async16(dk + off, kh + at, in ? 16 : 0);
        cp_async16(dv + off, vh + at, in ? 16 : 0);
      }
      if (tid < kF32N) {  // keys past the end read as masked (0)
        const bool in = k0 + tid < seq;
        cp_async4(sbase + 4 * (L::kMask + st * kF32N + tid),
                  mrow + (in ? k0 + tid : 0), in ? 4 : 0);
      }
    }
    cp_async_commit();  // one group a step, empty past the last
  };

  float acc[4][D / 8];
  float m[4], l[4];  // l: this thread's share of each row's sum
  f32_reset<D>(acc, m, l);
#pragma unroll
  for (int t = 0; t < kF32Stages - 1; ++t) load(t);

  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kF32Stages - 2>();  // this thread's copies of step t
    __syncthreads();  // everyone's, and step t - 1's stage is free
    load(t + kF32Stages - 1);
    const int it = t < n0 ? 0 : 1;
    const int kt = it ? t - n0 : t;
    const int st = t % kF32Stages;
    const int row0 = (it ? tile1 : tile0) * kF32M;
    const int k0 = kt * kF32N;
    const float* qs = fsm + L::kQ + it * L::kTileQ + rg * L::kRow;
    const float* ks = fsm + L::kK + st * L::kTile + g * L::kRow;
    const float* vs = fsm + L::kV + st * L::kTile;
    const int32_t* ms =
        reinterpret_cast<const int32_t*>(fsm + L::kMask + st * kF32N);

    // S = Q K^T on this thread's 4 x 8: each dot over d in order
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    }
#pragma unroll
    for (int w = 0; w < D / 4; ++w) {
      float4 a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(qs + 32 * i * L::kRow + 4 * w);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        b[j] = *reinterpret_cast<const float4*>(ks + 8 * j * L::kRow + 4 * w);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
      }
    }

    // scale; dead keys and, on the diagonal, keys past the row become
    // exactly -1e30. live_lo/hi: bit x is key k0 + x (+ 32) live
    const uint32_t live_lo = __ballot_sync(0xffffffffu, ms[lane] > 0);
    const uint32_t live_hi = __ballot_sync(0xffffffffu, ms[32 + lane] > 0);
    const bool diag = causal && k0 + kF32N - 1 > row0;
    float mx[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
    if (!diag && (live_lo & live_hi) == 0xffffffffu) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = __fmul_rn(s[i][j], scale);
          mx[i] = fmaxf(mx[i], s[i][j]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t word = j < 4 ? live_lo : live_hi;
          const bool dead = !((word >> (g + 8 * (j % 4))) & 1u);
          float y = __fmul_rn(s[i][j], scale);
          if (dead || (causal && k0 + g + 8 * j > row0 + rg + 32 * i)) {
            y = kNegInf;
          }
          s[i][j] = y;
          mx[i] = fmaxf(mx[i], y);
        }
      }
    }

    // the online update, once a tile: the row's max over its 8 lanes, p
    // gated (a fully masked row has m = -1e30 itself, and exp(s - m)
    // would be 1), log2(e) folded into exp2 after the gate
    float alpha[4], m_log2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 4));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2_ftz((m[i] - m_new) * kLog2e);
      m[i] = m_new;
      m_log2[i] = m_new * kLog2e;
    }
    // Where every row of the warp has m > -1e30 / 4, an entry the gate
    // zeroes (s <= -1e30 / 2) gives exp2 of less than -3.6e29, exactly 0
    // as well, so the gate's compare is skipped with the same result
    const float m_min = fminf(fminf(m[0], m[1]), fminf(m[2], m[3]));
    const bool live_rows = __all_sync(0xffffffffu, m_min > kNegInf / 4);
    if (live_rows) {
      f32_exp_rows<false, D>(s, m_log2, alpha, l, acc);
    } else {
      f32_exp_rows<true, D>(s, m_log2, alpha, l, acc);
    }

    // P^T: key g + 8j, the 4 rows in slot chunk rg; only this warp's row
    // groups read these slots, and the barrier at the next step's top
    // orders this tile's reads before the next writes
    float* pt = fsm + L::kP;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float4*>(pt + (g + 8 * j) * L::kPRow + 4 * rg) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncwarp();

    // O += P V: per key, P's 4 rows in one load, V's D / 8 columns
    const float* pr = pt + 4 * rg;
#pragma unroll
    for (int key = 0; key < kF32N; ++key) {
      const float4 p = *reinterpret_cast<const float4*>(pr + key * L::kPRow);
      float y[D / 8];
      f32_load_cols<D>(vs + key * L::kRow, g, y);
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        acc[0][c] = fmaf(p.x, y[c], acc[0][c]);
        acc[1][c] = fmaf(p.y, y[c], acc[1][c]);
        acc[2][c] = fmaf(p.z, y[c], acc[2][c]);
        acc[3][c] = fmaf(p.w, y[c], acc[3][c]);
      }
    }

    if (kt == (it ? steps - n0 : n0) - 1) {  // the item's last tile
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float lt = l[i];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        lt += __shfl_xor_sync(0xffffffffu, lt, 4);
        // fully masked rows have l == 0: zeros, not NaN
        const float safe_l = lt > 0.f ? lt : 1.f;
        const int row = row0 + rg + 32 * i;
        if (row < seq) {
          float y[D / 8];
#pragma unroll
          for (int c = 0; c < D / 8; ++c) y[c] = acc[i][c] / safe_l;
          f32_store_cols<D>(o + (head + row) * D, g, y);
          if (g == 0) lse[head + row] = m[i] + logf(safe_l);
        }
      }
      f32_reset<D>(acc, m, l);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, fetched through the runtime so
// that the library links nothing beyond cudart
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a [bh, seq, D] bf16 tensor as TMA sees it: tiles of 128 rows x D, rows
// past seq zero-filled, swizzled to the row width
template <int D>
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int bh, int seq) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {D, static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {D * 2, static_cast<cuuint64_t>(seq) * D * 2};
  const cuuint32_t box[3] = {D, kBlockN, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
              : (D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                         : CU_TENSOR_MAP_SWIZZLE_32B);
  const CUresult r =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* mask, void* o, void* lse, int bh, int seq,
                        int heads, float scale, int causal, int device,
                        cudaStream_t stream) {
  // a block may use more than 48 KB of shared memory only once allowed;
  // the attribute is set once per device
  static std::atomic<unsigned long long> allowed{0};
  const unsigned long long bit = 1ull << (device % 64);
  if (!(allowed.load() & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<D>::kAlloc);
    if (err != cudaSuccess) return err;
    allowed.fetch_or(bit);
  }
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = tensor_map<D>(&mq, q, bh, seq)) != cudaSuccess) return err;
  if ((err = tensor_map<D>(&mk, k, bh, seq)) != cudaSuccess) return err;
  if ((err = tensor_map<D>(&mv, v, bh, seq)) != cudaSuccess) return err;
  // persistent: one block per SM, or one per item if there are fewer
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long items =
      static_cast<long long>((seq + kBlockM - 1) / kBlockM) * bh;
  if (items > (1LL << 31) - 1) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(items < sms ? items : sms);
  flash_fwd_bf16_kernel<D><<<grid, kThreads, Smem<D>::kAlloc, stream>>>(
      mq, mk, mv, static_cast<const int32_t*>(mask),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), seq, heads,
      bh, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* mask, void* o, void* lse, int bh, int seq,
                       int heads, float scale, int causal, int device,
                       cudaStream_t stream) {
  static std::atomic<unsigned long long> allowed{0};
  const unsigned long long bit = 1ull << (device % 64);
  if (!(allowed.load() & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        F32Smem<D>::kBytes);
    if (err != cudaSuccess) return err;
    allowed.fetch_or(bit);
  }
  // two query tiles a block (with causal, i and n - 1 - i)
  const int q_tiles = (seq + kF32M - 1) / kF32M;
  const dim3 grid((q_tiles + 1) / 2, bh);
  flash_fwd_f32_kernel<D><<<grid, kF32Threads, F32Smem<D>::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(mask),
      static_cast<float*>(o), static_cast<float*>(lse), seq, heads, scale,
      causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int is_bf16, const void* q, const void* k, const void* v,
                   const void* mask, void* o, void* lse, int bh, int seq,
                   int heads, float scale, int causal, int device,
                   cudaStream_t stream) {
  if (is_bf16) {
    return launch_bf16<D>(q, k, v, mask, o, lse, bh, seq, heads, scale,
                          causal, device, stream);
  }
  return launch_f32<D>(q, k, v, mask, o, lse, bh, seq, heads, scale, causal,
                       device, stream);
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous [bh, seq, head_dim], bf16 if is_bf16 else f32,
// q, k and v 16-byte aligned (TMA and cp.async require it); mask: contiguous
// [bh / heads, seq] int32 (1 = attend); lse: [bh, seq] f32. head_dim is
// 16, 32 or 64. Launches on `stream`, does not synchronise, and returns
// the first CUDA error of the set-up or the launch (0 if none).
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
            static_cast<int>(seq), static_cast<int>(heads), scale, causal,   \
            device, s)
  if (head_dim == 16) err = PS_LAUNCH(16);
  else if (head_dim == 32) err = PS_LAUNCH(32);
  else if (head_dim == 64) err = PS_LAUNCH(64);
  else err = cudaErrorInvalidValue;
#undef PS_LAUNCH
  return static_cast<int>(err);
}

const char* ps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
