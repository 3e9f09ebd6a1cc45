// Thread-block clusters: the launch and occupancy helpers of the kernels
// that spread one channel (or PRN) over a cluster of blocks (K3 and K3-hd
// in multicorr.cu, K3-loop in scan_loop.cu, K1-loop and K1-seg in
// fast_loop.cu, K2d in acq.cu).
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
#include <stdint.h>

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

// cluster.sync() split in two: every thread arrives where its block
// starts (relaxed: it publishes no memory) and waits before its block
// first touches another block's shared memory, which is then known to
// run; the latency of the barrier hides behind the work between.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// A transaction barrier (mbarrier) in shared memory that other blocks of
// the cluster arrive on: one thread initialises it for ``count``
// arrivals before its block's cluster_arrive_relaxed(), the fence making
// the initialisation visible to the cluster.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile(
      "mbarrier.init.shared::cta.b64 [%0], %1;\n"
      "fence.mbarrier_init.release.cluster;\n" ::"r"(
          static_cast<unsigned>(__cvta_generic_to_shared(bar))),
      "r"(count)
      : "memory");
}

// Arrive on the barrier at ``bar``'s offset in block ``rank``'s shared
// memory, releasing this thread's earlier writes (into that block's
// shared memory too) to the threads that wait on it.
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar,
                                                   unsigned rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(bar))),
      "r"(rank)
      : "memory");
}

// Wait until phase ``parity`` of this block's barrier ``bar`` completes,
// acquiring what the arrivals released.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(bar))),
      "r"(parity)
      : "memory");
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
