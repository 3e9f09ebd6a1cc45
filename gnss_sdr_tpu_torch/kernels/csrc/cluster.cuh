// Thread-block clusters: the launch and occupancy helpers of the kernels
// that spread one channel over a cluster of blocks (K3 in multicorr.cu,
// K3-loop in scan_loop.cu, K1-loop and K1-seg in fast_loop.cu).
//
// A cluster's blocks run at once on neighbouring SMs of one GPC and read
// and write each other's shared memory (cooperative_groups::this_cluster,
// map_shared_rank). The grid is clusters x S blocks along x, so cluster
// c is blocks c S .. c S + S - 1 and a block's channel is blockIdx.x / S.
// A launch the card cannot hold (a cluster larger than a GPC's free SMs,
// too much shared memory) is refused and its error returned: no kernel
// runs as smaller clusters or as one block a channel instead.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <utility>

namespace cg = cooperative_groups;

// the cluster size every sm_90 card launches; above it, up to 16 blocks
// with the non-portable opt-in
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;
// dynamic shared memory a launch gets without opting in
constexpr size_t kSmemNoOptIn = 48 * 1024;

// The launch configuration of clusters x S blocks of ``threads`` threads
// with ``smem`` bytes of dynamic shared memory (``attr`` backs it), after
// the kernel's opt-ins: shared memory above 48 KB, clusters above 8.
template <typename K>
cudaError_t cluster_config(K* kernel, int clusters, int S, int threads,
                           size_t smem, cudaStream_t stream,
                           cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute* attr) {
  if (S < 1 || S > kMaxCluster || clusters < 1) return cudaErrorInvalidValue;
  if (smem > kSmemNoOptIn) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  if (S > kPortableCluster) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(clusters * S);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// Launch ``kernel(args...)`` as ``clusters`` clusters of S blocks; the
// launch's error, then cudaGetLastError()'s.
template <typename... Exp, typename... Act>
int cluster_launch(void (*kernel)(Exp...), int clusters, int S, int threads,
                   size_t smem, cudaStream_t stream, Act&&... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = cluster_config(kernel, clusters, S, threads, smem, stream,
                                 cfg, attr);
  if (e == cudaSuccess)
    e = cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
  if (e != cudaSuccess) {
    cudaGetLastError();   // the error is returned, not left pending
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// cudaOccupancyMaxActiveClusters of ``kernel`` in clusters of S blocks
// on the current card: how many such clusters it holds at once.
template <typename K>
int cluster_occupancy(K* kernel, int S, int threads, size_t smem,
                      int* n_active) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = cluster_config(kernel, 1, S, threads, smem, nullptr, cfg,
                                 attr);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(n_active, kernel,
                                                           &cfg);
  return static_cast<int>(e);
}
