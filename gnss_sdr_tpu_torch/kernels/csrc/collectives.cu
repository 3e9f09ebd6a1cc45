// K8: the two collectives of the sharded receiver.
//
//   (a) halo_exchange replaces gnss_sdr_tpu/parallel/multihost.py::
//       halo_exchange_blocks (a shard_map of ppermute + concatenate): for
//       each output shard d it writes, row by row,
//         dst[d][r] = [ src[d][r][0:L] | succ[d][r][0:H] ],
//       succ[d] the successor's head (shard d + 1, a staged copy of it, or
//       the head another process sent), or zeros where d has no successor
//       (the last shard: ppermute zero-fills a target no pair addresses).
//       One kernel for every element type: the rows are copied as bytes
//       (float32 [L] shards, the planar int8 ring's [2, L] time shards).
//   (b) grid_allreduce replaces multihost.py::allreduce_noncoherent_grid
//       (a shard_map of psum): the n shards' float32 grids summed in
//       shard order 0..n-1, the total written into every output grid.
//
// Both take one device pointer per shard, so one kernel serves every mesh:
// n pointers into one card's memory (a logical mesh), pointers into the
// peer cards of one process (read over NVLink once the launcher has
// enabled peer access), or the buffers torch.distributed received.
//
// Bound: both move bytes and do at most n - 1 additions an element: (a)
// reads and writes n (L + H) elements, (b) reads n grids and writes each
// output grid once. Design: 16-byte vector loads and stores in a
// grid-stride loop; (a) aligns each row's stores to 16 bytes and takes the
// few bytes before and after with byte copies, and falls back to byte
// copies where source and destination are not aligned alike; (b) runs
// float4 lanes when every pointer is 16-byte aligned and the tail element
// by element. (b) adds with __fadd_rn in shard order, the plain version's
// order, so the two agree to the bit.
#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kMaxShards = 32;

// the launch arguments (by value; the launchers' C interface takes them by
// pointer)
struct HaloArgs {
  const char* src[kMaxShards];       // output shard d's own rows
  const char* succ[kMaxShards];      // its successor's head, or null: zeros
  char* dst[kMaxShards];             // output shard d, rows of body + halo
  long long src_stride[kMaxShards];  // bytes between rows of src[d]
  long long succ_stride[kMaxShards];
  long long dst_stride;              // bytes between rows of dst[d]
  long long body;                    // bytes of a shard row
  long long halo;                    // bytes of the halo
  int n;                             // output shards of this launch
  int rows;
};

struct ReduceArgs {
  const float* grids[kMaxShards];  // every shard's grid, in shard order
  float* out[kMaxShards];          // the output grids of this launch
  int n_in;
  int n_out;
  long long numel;
  int vec;                         // all pointers 16-byte aligned
};

namespace {

// nbytes from s (null: zeros) to o by the threads of the blocks along x
__device__ void copy_bytes(const char* __restrict__ s, char* __restrict__ o,
                           long long nbytes) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long head = static_cast<long long>(
      (16 - (reinterpret_cast<uintptr_t>(o) & 15)) & 15);
  if (head > nbytes) head = nbytes;
  const bool alike =
      s == nullptr ||
      ((reinterpret_cast<uintptr_t>(s) + head) & 15) == 0;
  if (!alike) {
    for (long long i = tid; i < nbytes; i += stride) o[i] = s[i];
    return;
  }
  for (long long i = tid; i < head; i += stride) o[i] = s ? s[i] : 0;
  const long long nvec = (nbytes - head) >> 4;
  uint4* ov = reinterpret_cast<uint4*>(o + head);
  if (s) {
    const uint4* sv = reinterpret_cast<const uint4*>(s + head);
    for (long long v = tid; v < nvec; v += stride) ov[v] = sv[v];
  } else {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (long long v = tid; v < nvec; v += stride) ov[v] = z;
  }
  for (long long i = head + (nvec << 4) + tid; i < nbytes; i += stride)
    o[i] = s ? s[i] : 0;
}

// blockIdx.y = (d * rows + r) * 2 + part: part 0 the shard's own row,
// part 1 its halo
__global__ void __launch_bounds__(kThreads)
halo_exchange_kernel(const HaloArgs a) {
  const int job = blockIdx.y;
  const int part = job & 1;
  const int r = (job >> 1) % a.rows;
  const int d = (job >> 1) / a.rows;
  char* row = a.dst[d] + r * a.dst_stride;
  if (part == 0) {
    copy_bytes(a.src[d] + r * a.src_stride[d], row, a.body);
  } else {
    const char* s = a.succ[d] ? a.succ[d] + r * a.succ_stride[d] : nullptr;
    copy_bytes(s, row + a.body, a.halo);
  }
}

__global__ void __launch_bounds__(kThreads)
grid_allreduce_kernel(const ReduceArgs a) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (a.vec) {
    const long long nvec = a.numel >> 2;
    for (long long v = tid; v < nvec; v += stride) {
      float4 acc = reinterpret_cast<const float4*>(a.grids[0])[v];
      for (int k = 1; k < a.n_in; ++k) {
        const float4 x = reinterpret_cast<const float4*>(a.grids[k])[v];
        acc.x = __fadd_rn(acc.x, x.x);
        acc.y = __fadd_rn(acc.y, x.y);
        acc.z = __fadd_rn(acc.z, x.z);
        acc.w = __fadd_rn(acc.w, x.w);
      }
      for (int j = 0; j < a.n_out; ++j)
        reinterpret_cast<float4*>(a.out[j])[v] = acc;
    }
    done = nvec << 2;
  }
  for (long long i = done + tid; i < a.numel; i += stride) {
    float acc = a.grids[0][i];
    for (int k = 1; k < a.n_in; ++k) acc = __fadd_rn(acc, a.grids[k][i]);
    for (int j = 0; j < a.n_out; ++j) a.out[j][i] = acc;
  }
}

// enough blocks along x to cover `units` units a job, at most 2048 in all
// (eight blocks of 256 threads on each of the 132 SMs and some to spare)
unsigned blocks_along(long long units, int jobs) {
  long long b = (units + kThreads - 1) / kThreads;
  const long long cap = jobs >= 2048 ? 1 : 2048 / jobs;
  if (b > cap) b = cap;
  return static_cast<unsigned>(b < 1 ? 1 : b);
}

}  // namespace

extern "C" {

int collectives_max_shards() { return kMaxShards; }

int halo_exchange(const HaloArgs* a, void* stream) {
  if (a->n < 1 || a->n > kMaxShards || a->rows < 1) return 1;  // invalid
  const int jobs = a->n * a->rows * 2;
  if (jobs > 65535) return 1;
  const long long longest = a->body > a->halo ? a->body : a->halo;
  const dim3 grid(blocks_along((longest + 15) >> 4, jobs), jobs);
  halo_exchange_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

int grid_allreduce(const ReduceArgs* a, void* stream) {
  if (a->n_in < 1 || a->n_in > kMaxShards || a->n_out < 1 ||
      a->n_out > kMaxShards)
    return 1;
  const long long units = a->vec ? (a->numel + 3) >> 2 : a->numel;
  grid_allreduce_kernel<<<blocks_along(units, 1), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// Let kernels on `dev` read `peer`'s memory; the current device is kept.
int enable_peer_access(int dev, int peer) {
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(dev);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      err = cudaSuccess;
    }
  }
  cudaSetDevice(cur);
  return static_cast<int>(err);
}

}  // extern "C"
