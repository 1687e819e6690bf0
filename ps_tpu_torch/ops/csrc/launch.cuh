// Launch helpers shared by the port's kernels.
//
// Programmatic dependent launch (Hopper): a kernel launched through
// launch_pdl may be scheduled while the kernel before it on the stream is
// still running, so its launch latency hides behind that kernel's tail.
// Every such kernel calls pdl_wait() before it reads anything an earlier
// kernel wrote: it returns once the earlier grid has finished and its
// writes are visible. pdl_trigger() lets the next kernel be scheduled.
#pragma once

#include <cuda_runtime.h>

namespace ps {

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Launch `kernel` on `stream` with programmatic dependent launch and, where
// `cluster` > 1, in thread block clusters of that many blocks along x.
template <typename... KArgs, typename... Args>
cudaError_t launch_pdl_cluster(void (*kernel)(KArgs...), dim3 grid,
                               dim3 block, size_t smem, cudaStream_t stream,
                               unsigned cluster, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cluster > 1) {
    attr[1].id = cudaLaunchAttributeClusterDimension;
    attr[1].val.clusterDim.x = cluster;
    attr[1].val.clusterDim.y = 1;
    attr[1].val.clusterDim.z = 1;
    cfg.numAttrs = 2;
  }
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
}

template <typename... KArgs, typename... Args>
cudaError_t launch_pdl(void (*kernel)(KArgs...), dim3 grid, dim3 block,
                       size_t smem, cudaStream_t stream, Args... args) {
  return launch_pdl_cluster(kernel, grid, block, smem, stream, 1u, args...);
}

// The device's SM count, asked once per device.
inline int sm_count(int device) {
  static int counts[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (counts[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess ||
        n <= 0) {
      cudaGetLastError();  // clear it: the count only sizes a grid
      n = 132;
    }
    counts[device] = n;
  }
  return counts[device];
}

}  // namespace ps
