// Grouping pass of the fused sparse apply: a stable sort of a push's ids
// and the table of their segments, in one launch at the Wide-&-Deep batch.
//
// Replaces, with csrc/sparse_apply.cu, the TPU kernel in
// ps_tpu/ops/sparse_apply.py (_apply_pallas, pl.pallas_call at l.297) and the
// batch_segment_sum at l.80 that feeds it: this file is that function's
// jnp.argsort and segment boundaries.
//
// What it computes, for ids [n] int32 and a table of num_rows rows: the key
// of an id is the id where 0 <= id < num_rows and num_rows otherwise
// (filler: -1 and ids past the table), so filler sorts after every real id
// and is never applied. Outputs:
//   ids_s [n]      the keys, sorted stably (filler shows as num_rows)
//   perm  [n]      the stable permutation: ids_s[i] = key(ids[perm[i]])
//   seg_start [U+1], seg_id [U]: segment s (one per unique real id, in
//                  ascending id order) is ids_s[seg_start[s] : seg_start[s+1]]
//                  and its id is seg_id[s]; seg_start[U] = lo + n_real
//   meta [3]       U, n_real (ids in [0, num_rows)), lo (index of the first
//                  real id in ids_s: 0 here, the count of negative ids on the
//                  sorted path)
// On the real ids, ids_s and perm equal torch.sort(ids, stable=True)'s.
//
// What bounds it on an H100: not bytes (n = 13,312 ids are 53 KB, ~0.02 us
// at 3.35 TB/s) but instructions and the latency of a chain of dependent
// steps. A first design sorted in one block of 1,024 threads and was
// issue-bound on its one SM (each key costs dozens of instructions a pass
// to count and rank), slower than torch.sort. The design:
//
// - n <= 16,384 (group_cluster_kernel): a cluster of 8 blocks on 8 SMs
//   (Hopper's thread block clusters; each block reads and writes the
//   others' shared memory) sorts by LSD radix over only the key bits that
//   num_rows allows (22 for 2,600,000 rows: two passes of 11 bits). Block
//   r owns sorted slots [2,048 r, 2,048 (r + 1)). Each pass is stable with
//   no global memory: warp w of block r owns a contiguous run of the input
//   and counts its digits into its own counters (uint16, packed in pairs for
//   shared-memory atomics: 16 warps x 2,048 digits); the counters are
//   scanned digit-major, then block-major, then warp-major across the
//   cluster, so equal digits keep their input order; a tile of 32 keys is
//   ranked by one ballot per digit bit; each key goes straight to its slot
//   in the owning block's shared memory. Other blocks' memory is reached
//   by explicit cluster addresses (mapa, ld/st.shared::cluster), which
//   read the digit totals faster than generic pointers did. The
//   same launch then writes the segment table, so the apply never scans
//   for a segment's end or asks whether it is first.
// - larger n (a production batch of 65,536 x 26 ids does not fit a
//   cluster's shared memory): the wrapper sorts with torch.sort, and two
//   launches here build the same segment table from the sorted ids
//   (seg_count_kernel counts each tile's segments, seg_write_kernel writes
//   them at their scanned offsets).
//
// Tensor cores play no part. What serves it is shared memory spread over a
// cluster (distributed shared memory), warp ballots, and programmatic
// dependent launch (launch.cuh), which lets the apply kernel be scheduled
// while this one runs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;                    // blocks, one SM each
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTiles = 4;                      // 32-key tiles a warp
constexpr int kSlots = kWarps * kTiles * 32;   // 2,048 sorted slots a block
constexpr int kBlockMax = kCluster * kSlots;   // 16,384
constexpr int kMaxDigits = 2048;               // 11-bit digits at most
constexpr int kDigitsPer = kMaxDigits / kThreads;  // digits a thread
constexpr int kWords = kDigitsPer / 2;  // their uint16 counters, in pairs
static_assert(kWords == 2, "a thread's counters of a warp are one uint2");
// shared memory: per-warp digit counters, the block's digit totals
// (uint16: a block holds at most 2,048 keys), its slots (key | position
// << 32), warp sums, segment counts
constexpr size_t kSmemBytes = kWarps * kMaxDigits * sizeof(uint16_t) +
                              kMaxDigits * sizeof(uint16_t) +
                              kSlots * sizeof(uint64_t) +
                              32 * sizeof(uint32_t) +
                              2 * kCluster * sizeof(uint32_t);

constexpr int kSegThreads = 1024;
constexpr int kSegItems = 8;
constexpr int kSegTile = kSegThreads * kSegItems;  // 8,192 sorted ids a block

// Exclusive sum of x over the block (in thread order); *total gets the sum
// of all. Uses wsum[32]; ends with a barrier, so wsum may be reused.
__device__ __forceinline__ uint32_t block_exclusive_sum(uint32_t x,
                                                        uint32_t* wsum,
                                                        uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  uint32_t v = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += y;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < warps ? wsum[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    wsum[lane] = w;
  }
  __syncthreads();
  const uint32_t before = warp > 0 ? wsum[warp - 1] : 0;
  *total = wsum[31];
  __syncthreads();
  return before + v - x;
}

// Distributed shared memory by explicit cluster addresses: the address of
// `p` (this block's shared memory) in block `rank` of the cluster, and
// loads and stores there.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ uint2 ld_cluster_v2(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared::cluster.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t ld_cluster_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_cluster_u64(uint32_t addr, uint64_t v) {
  asm volatile("st.shared::cluster.u64 [%0], %1;" ::"r"(addr), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint32_t lanemask_lt() {
  uint32_t m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The lanes whose digit equals this lane's, among those in `valid`: one
// ballot per digit bit. It computes what __match_any_sync does, which was
// the slower of the two on an H100.
__device__ __forceinline__ uint32_t match_digit(uint32_t dig, int bits,
                                                uint32_t valid) {
  uint32_t peers = valid;
  for (int b = 0; b < bits; ++b) {
    const bool set = (dig >> b) & 1u;
    const uint32_t ones = __ballot_sync(0xffffffffu, set);
    peers &= set ? ones : ~ones;
  }
  return peers;
}

// A cluster of kCluster blocks sorts n <= kBlockMax ids and writes the
// segment table.
__global__ void __launch_bounds__(kThreads, 1)
    group_cluster_kernel(const int32_t* __restrict__ ids, int n,
                         uint32_t num_rows, int passes, int bits,
                         int32_t* __restrict__ ids_s,
                         int32_t* __restrict__ perm,
                         int32_t* __restrict__ seg_start,
                         int32_t* __restrict__ seg_id,
                         int32_t* __restrict__ meta) {
  ps::pdl_wait();
  ps::pdl_trigger();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ uint4 smem[];
  uint16_t* hist = reinterpret_cast<uint16_t*>(smem);  // [warp][digit]
  uint32_t* hist32 = reinterpret_cast<uint32_t*>(smem);
  uint16_t* btot = hist + kWarps * kMaxDigits;
  uint64_t* slots = reinterpret_cast<uint64_t*>(btot + kMaxDigits);
  uint32_t* wsum = reinterpret_cast<uint32_t*>(slots + kSlots);
  uint32_t* counts = wsum + 32;  // each block's segments and real ids

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slot0 = rank * kSlots;  // the block's first slot (and input)
  const uint32_t lt = lanemask_lt();

  // the block's run of the input, 32 keys a tile, each warp its own run
  uint32_t key[kTiles], pos[kTiles];
  bool valid[kTiles];
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    const int i = slot0 + (warp * kTiles + t) * 32 + lane;
    valid[t] = i < n;
    key[t] = num_rows;
    pos[t] = 0;
    if (valid[t]) {
      const uint32_t id = static_cast<uint32_t>(ids[i]);  // -1 is huge
      key[t] = id < num_rows ? id : num_rows;
      pos[t] = static_cast<uint32_t>(i);
    }
  }

  const uint32_t dmask = (1u << bits) - 1u;
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = pass * bits;
    if (pass > 0) {  // last pass's scatter left this block's slots here
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        if (valid[t]) {
          const int local = (warp * kTiles + t) * 32 + lane;
          key[t] = static_cast<uint32_t>(slots[local]);
          pos[t] = static_cast<uint32_t>(slots[local] >> 32);
        }
      }
    }
    uint4* h4 = reinterpret_cast<uint4*>(hist);
    for (int k = tid; k < kWarps * kMaxDigits * 2 / 16; k += kThreads) {
      h4[k] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();

    // count: each warp its digits (order does not matter for a count)
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      if (valid[t]) {
        const uint32_t dig = (key[t] >> shift) & dmask;
        atomicAdd(&hist32[warp * (kMaxDigits / 2) + (dig >> 1)],
                  1u << ((dig & 1u) * 16));
      }
    }
    __syncthreads();
    // the block's total per digit: thread t holds kDigitsPer digits of
    // every warp, as kWords words of two uint16 counters
    uint32_t cnt[kWarps][kWords];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        cnt[w][j] = reinterpret_cast<const uint32_t*>(
            hist + w * kMaxDigits)[tid * kWords + j];
      }
    }
    uint32_t mine[kDigitsPer] = {};
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        mine[2 * j] += cnt[w][j] & 0xffffu;
        mine[2 * j + 1] += cnt[w][j] >> 16;
      }
    }
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      reinterpret_cast<uint32_t*>(btot)[tid * kWords + j] =
          mine[2 * j] | (mine[2 * j + 1] << 16);
    }
    cluster.sync();  // every block's digit totals are in place

    // scan: digit-major, then block, then warp, across the cluster
    uint32_t theirs[kCluster][kWords];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const uint2 v = ld_cluster_v2(cluster_addr(btot + tid * kDigitsPer, r));
      theirs[r][0] = v.x;
      theirs[r][1] = v.y;
    }
    uint32_t all[kDigitsPer] = {};
    uint32_t before[kDigitsPer] = {};
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
#pragma unroll
      for (int k = 0; k < kDigitsPer; ++k) {
        const uint32_t v = (theirs[r][k / 2] >> (16 * (k % 2))) & 0xffffu;
        all[k] += v;
        if (r < rank) before[k] += v;
      }
    }
    uint32_t sum = 0;
#pragma unroll
    for (int k = 0; k < kDigitsPer; ++k) sum += all[k];
    uint32_t total;
    uint32_t base = block_exclusive_sum(sum, wsum, &total);
    uint32_t run[kDigitsPer];
#pragma unroll
    for (int k = 0; k < kDigitsPer; ++k) {
      run[k] = base + before[k];
      base += all[k];
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        reinterpret_cast<uint32_t*>(hist + w * kMaxDigits)[tid * kWords + j] =
            run[2 * j] | (run[2 * j + 1] << 16);
        run[2 * j] += cnt[w][j] & 0xffffu;
        run[2 * j + 1] += cnt[w][j] >> 16;
      }
    }
    __syncthreads();

    // scatter: lanes sharing a digit keep their order; each key goes to
    // its slot in the owning block's shared memory
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      const uint32_t vmask = __ballot_sync(0xffffffffu, valid[t]);
      if (vmask) {
        const uint32_t dig = (key[t] >> shift) & dmask;
        const uint32_t peers = match_digit(dig, bits, vmask);
        const int leader = valid[t] ? __ffs(peers) - 1 : lane;
        uint16_t* cell = &hist[warp * kMaxDigits + dig];
        uint32_t at = 0;
        if (valid[t] && lane == leader) at = *cell;
        at = __shfl_sync(0xffffffffu, at, leader);
        if (valid[t]) {
          const uint32_t dst = at + __popc(peers & lt);
          const int owner = static_cast<int>(dst / kSlots);
          st_cluster_u64(cluster_addr(slots + dst % kSlots, owner),
                         key[t] | (static_cast<uint64_t>(pos[t]) << 32));
        }
        if (valid[t] && lane == leader) {
          *cell = static_cast<uint16_t>(at + __popc(peers));
        }
        __syncwarp();
      }
    }
    cluster.sync();  // every key is in its slot
  }

  // this block's slots: sorted keys and permutation, coalesced
  const int mine = max(0, min(kSlots, n - slot0));
  for (int i = tid; i < mine; i += kThreads) {
    ids_s[slot0 + i] = static_cast<int32_t>(slots[i]);
    perm[slot0 + i] = static_cast<int32_t>(slots[i] >> 32);
  }
  // the segment table: each thread a run of 4 slots, in order
  const uint32_t prev_last =
      rank > 0 ? ld_cluster_u32(cluster_addr(slots + kSlots - 1, rank - 1))
               : 0;
  const int lo = tid * kTiles, hi = min(lo + kTiles, mine);
  uint32_t heads = 0, reals = 0;
  for (int i = lo; i < hi; ++i) {
    const uint32_t k = static_cast<uint32_t>(slots[i]);
    const bool first =
        slot0 + i == 0 ||
        (i > 0 ? static_cast<uint32_t>(slots[i - 1]) : prev_last) != k;
    if (k < num_rows) {
      ++reals;
      if (first) ++heads;
    }
  }
  uint32_t total;  // reals <= 2,048 stay in the low half
  const uint32_t before =
      block_exclusive_sum((heads << 16) | reals, wsum, &total);
  if (tid < kCluster) {  // this block's counts, into every block
    st_cluster_u64(cluster_addr(counts + 2 * rank, tid),
                   (total >> 16) | (static_cast<uint64_t>(total & 0xffffu)
                                    << 32));
  }
  // every block's counts are in place; past this barrier no block touches
  // another's shared memory, so each may leave when it is done
  cluster.sync();
  uint32_t segs_before = 0, segs_all = 0, reals_all = 0;
  for (int r = 0; r < kCluster; ++r) {
    const uint32_t segs = counts[2 * r];
    if (r < rank) segs_before += segs;
    segs_all += segs;
    reals_all += counts[2 * r + 1];
  }
  uint32_t s = segs_before + (before >> 16);
  for (int i = lo; i < hi; ++i) {
    const uint32_t k = static_cast<uint32_t>(slots[i]);
    const bool first =
        slot0 + i == 0 ||
        (i > 0 ? static_cast<uint32_t>(slots[i - 1]) : prev_last) != k;
    if (k < num_rows && first) {
      seg_start[s] = slot0 + i;
      seg_id[s] = static_cast<int32_t>(k);
      ++s;
    }
  }
  if (rank == kCluster - 1 && tid == 0) {
    meta[0] = static_cast<int32_t>(segs_all);
    meta[1] = static_cast<int32_t>(reals_all);
    meta[2] = 0;
    seg_start[segs_all] = static_cast<int32_t>(reals_all);
  }
}

// Sum of three per-thread counts over the block, into out[0..2].
__device__ __forceinline__ void block_sum3(uint32_t a, uint32_t b, uint32_t c,
                                           uint32_t* acc) {
  a = __reduce_add_sync(0xffffffffu, a);
  b = __reduce_add_sync(0xffffffffu, b);
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&acc[0], a);
    atomicAdd(&acc[1], b);
    atomicAdd(&acc[2], c);
  }
}

// Sorted path, step 1: per tile of kSegTile sorted ids, its segments, real
// ids and negative ids; and the permutation narrowed to int32.
__global__ void __launch_bounds__(kSegThreads)
    seg_count_kernel(const int32_t* __restrict__ ids_s,
                     const int64_t* __restrict__ order, int64_t n,
                     int32_t num_rows, int32_t* __restrict__ perm,
                     int32_t* __restrict__ counts) {
  ps::pdl_wait();
  ps::pdl_trigger();
  __shared__ uint32_t acc[3];
  if (threadIdx.x < 3) acc[threadIdx.x] = 0;
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kSegTile;
  uint32_t heads = 0, reals = 0, negs = 0;
#pragma unroll
  for (int k = 0; k < kSegItems; ++k) {
    const int64_t i = base + k * kSegThreads + threadIdx.x;
    if (i < n) {
      const int32_t v = ids_s[i];
      perm[i] = static_cast<int32_t>(order[i]);
      if (v < 0) {
        ++negs;
      } else if (v < num_rows) {
        ++reals;
        if (i == 0 || ids_s[i - 1] != v) ++heads;
      }
    }
  }
  block_sum3(heads, reals, negs, acc);
  __syncthreads();
  if (threadIdx.x < 3) counts[3 * blockIdx.x + threadIdx.x] = acc[threadIdx.x];
}

// Sorted path, step 2: each tile's segments at their offset, in order; the
// last tile writes meta and the end of the last segment.
__global__ void __launch_bounds__(kSegThreads)
    seg_write_kernel(const int32_t* __restrict__ ids_s, int64_t n,
                     int32_t num_rows, const int32_t* __restrict__ counts,
                     int32_t* __restrict__ seg_start,
                     int32_t* __restrict__ seg_id,
                     int32_t* __restrict__ meta) {
  ps::pdl_wait();
  ps::pdl_trigger();
  __shared__ uint32_t acc[3];  // segments before this tile; all reals, negs
  __shared__ uint32_t wsum[32];
  if (threadIdx.x < 3) acc[threadIdx.x] = 0;
  __syncthreads();
  const bool last = blockIdx.x == gridDim.x - 1;
  uint32_t a = 0, b = 0, c = 0;
  for (int k = threadIdx.x; k < static_cast<int>(gridDim.x); k += kSegThreads) {
    if (k < static_cast<int>(blockIdx.x)) a += counts[3 * k];
    if (last) {
      b += counts[3 * k + 1];
      c += counts[3 * k + 2];
    }
  }
  block_sum3(a, b, c, acc);
  __syncthreads();

  const int64_t lo = static_cast<int64_t>(blockIdx.x) * kSegTile +
                     static_cast<int64_t>(threadIdx.x) * kSegItems;
  const int64_t hi = lo + kSegItems < n ? lo + kSegItems : n;
  uint32_t heads = 0;
  for (int64_t i = lo; i < hi; ++i) {
    const int32_t v = ids_s[i];
    if (v >= 0 && v < num_rows && (i == 0 || ids_s[i - 1] != v)) ++heads;
  }
  uint32_t tile_heads;
  uint32_t s = acc[0] + block_exclusive_sum(heads, wsum, &tile_heads);
  for (int64_t i = lo; i < hi; ++i) {
    const int32_t v = ids_s[i];
    if (v >= 0 && v < num_rows && (i == 0 || ids_s[i - 1] != v)) {
      seg_start[s] = static_cast<int32_t>(i);
      seg_id[s] = v;
      ++s;
    }
  }
  if (last && threadIdx.x == 0) {
    const uint32_t segs = acc[0] + tile_heads;
    meta[0] = static_cast<int32_t>(segs);
    meta[1] = static_cast<int32_t>(acc[1]);
    meta[2] = static_cast<int32_t>(acc[2]);
    seg_start[segs] = static_cast<int32_t>(acc[2] + acc[1]);
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// One launch of one cluster: sort n <= 16,384 ids (passes x bits >= the key
// bits of num_rows, bits <= 11) and write ids_s, perm [n], seg_start
// [n + 1], seg_id [n] and meta [3]. Returns a CUDA error code (0 =
// launched).
int ps_sparse_group_cluster(const void* ids, long long n, long long num_rows,
                          int passes, int bits, void* ids_s, void* perm,
                          void* seg_start, void* seg_id, void* meta,
                          int device, void* stream) {
  if (n <= 0) return 0;
  if (n > kBlockMax || bits < 1 || bits > 11 || passes < 1 ||
      passes * bits > 32 || num_rows < 0 || num_rows > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool sized[64] = {false};
  if (device < 0 || device >= 64 || !sized[device]) {
    err = cudaFuncSetAttribute(group_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (kCluster > 8) {  // beyond the portable cluster size
      err = cudaFuncSetAttribute(
          group_cluster_kernel,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (device >= 0 && device < 64) sized[device] = true;
  }
  err = ps::launch_pdl_cluster(
      group_cluster_kernel, dim3(kCluster), dim3(kThreads), kSmemBytes,
      static_cast<cudaStream_t>(stream), kCluster,
      static_cast<const int32_t*>(ids), static_cast<int>(n),
      static_cast<uint32_t>(num_rows), passes, bits,
      static_cast<int32_t*>(ids_s), static_cast<int32_t*>(perm),
      static_cast<int32_t*>(seg_start), static_cast<int32_t*>(seg_id),
      static_cast<int32_t*>(meta));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Two launches: from ids sorted by torch.sort (ids_s int32, order int64),
// write perm [n] int32, seg_start [n + 1], seg_id [n] and meta [3];
// counts is scratch of 3 * ceil(n / 8,192) ints.
int ps_sparse_group_sorted(const void* ids_s, const void* order, long long n,
                           long long num_rows, void* perm, void* seg_start,
                           void* seg_id, void* meta, void* counts, int device,
                           void* stream) {
  if (n <= 0) return 0;
  if (n > 0x7fffffffLL || num_rows < 0 || num_rows > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n + kSegTile - 1) / kSegTile);
  err = ps::launch_pdl(seg_count_kernel, dim3(blocks), dim3(kSegThreads), 0,
                       s, static_cast<const int32_t*>(ids_s),
                       static_cast<const int64_t*>(order),
                       static_cast<int64_t>(n),
                       static_cast<int32_t>(num_rows),
                       static_cast<int32_t*>(perm),
                       static_cast<int32_t*>(counts));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = ps::launch_pdl(seg_write_kernel, dim3(blocks), dim3(kSegThreads), 0,
                       s, static_cast<const int32_t*>(ids_s),
                       static_cast<int64_t>(n),
                       static_cast<int32_t>(num_rows),
                       static_cast<const int32_t*>(counts),
                       static_cast<int32_t*>(seg_start),
                       static_cast<int32_t*>(seg_id),
                       static_cast<int32_t*>(meta));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel, launched as any other: the floor a launch costs.
int ps_empty_launch(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* ps_group_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
