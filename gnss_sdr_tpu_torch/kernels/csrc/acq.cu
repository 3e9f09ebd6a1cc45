// K2: the PCPS acquisition grid around cuFFT.
//
// Replaces gnss_sdr_tpu/acquisition/pcps.py::_pcps_magnitude_grid with
// _cfar_statistics / _second_peak_statistics and the dwell sum of
// PcpsAcquisition.search. The transforms are torch.fft (cuFFT) calls in
// the wrapper; these kernels are the parts around them:
//   (a) acq_wipeoff: x[n] e^{j c0 f_d n} for every Doppler bin -> [D, N]
//       (wipeoff.cuh's body with S = 1, shared with K5a's fold)
//   (b) acq_product: spectrum[d] * conj_code_spectrum[p] -> [P, D, N]
//   (c1) acq_accum: |IFFT|^2 on [offset, offset + eff) added into the
//        dwell sum grid [P, D, eff], with each row's peak and first argmax
//   (c2) acq_stats: per PRN the peak, its first flat argmax (jnp.argmax
//        tie-break), the CFAR statistic (peak over the opposite Doppler
//        row's mean / 2 / dwells) and the first-vs-second-peak statistic
//        (circular +-1 chip exclusion in the peak row).
//
// Bound: the grid is large (P=32, D=40, N=4000: 41 MB complex per
// product, 20 MB per |.|^2 grid) and the arithmetic per element is a few
// flops, so every part is bound by bytes. Design: each kernel touches
// each element once, the |.|^2 grid is written once per dwell with its
// row peaks in the same pass, and the statistics read only the two rows
// they need. The wipe-off (a) is described in wipeoff.cuh. The product
// (b) writes P x D x N and reads D x N + P x N samples: a thread owns a
// pair of samples of one Doppler row, loads that row's pair once and
// walks the P code spectra (at most a few MB, held in L2), each pair
// moved as one 16-byte load or store.
#include "cluster.cuh"
#include "common.cuh"
#include "wipeoff.cuh"

namespace {

constexpr int kThreads = 256;

// out[p, d, n] = spec[d, n] * code[p, n] with the plain version's
// roundings (two products, then their difference or sum; no contraction).
__device__ __forceinline__ float cmul_re(float ar, float ai, float br,
                                         float bi) {
  return __fsub_rn(__fmul_rn(ar, br), __fmul_rn(ai, bi));
}
__device__ __forceinline__ float cmul_im(float ar, float ai, float br,
                                         float bi) {
  return __fadd_rn(__fmul_rn(ar, bi), __fmul_rn(ai, br));
}

// One row of blocks per Doppler bin d (blockIdx.y). kPairs: a thread owns
// the samples 2i, 2i + 1 of the row (N even, every base 16-byte aligned),
// one float4 each for spec, code and out; else one sample, one float2.
// Offsets within a row are 32-bit; a PRN's plane is one pointer step. The
// output is stored evict-first (__stcs): written once and not read here,
// it then does not push the code spectra out of L2 (E1, E5a: 72 and
// 111 MB of output against a 50 MB L2).
template <bool kPairs>
__global__ void __launch_bounds__(kThreads)
product_kernel(const float2* __restrict__ spec,
               const float2* __restrict__ code, int N, int D, int P,
               float2* __restrict__ out) {
  const int d = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const size_t plane = static_cast<size_t>(D) * N;
  const float2* srow = spec + static_cast<size_t>(d) * N;
  float2* orow = out + static_cast<size_t>(d) * N;
  if (kPairs) {
    if (i >= (N >> 1)) return;
    const float4 a = reinterpret_cast<const float4*>(srow)[i];
    const float4* c = reinterpret_cast<const float4*>(code) + i;
    float4* o = reinterpret_cast<float4*>(orow) + i;
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      const float4 b = *c;
      __stcs(o, make_float4(cmul_re(a.x, a.y, b.x, b.y),
                            cmul_im(a.x, a.y, b.x, b.y),
                            cmul_re(a.z, a.w, b.z, b.w),
                            cmul_im(a.z, a.w, b.z, b.w)));
      c += N >> 1;
      o += plane >> 1;
    }
  } else {
    if (i >= N) return;
    const float2 a = srow[i];
    const float2* c = code + i;
    float2* o = orow + i;
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      const float2 b = *c;
      __stcs(o, make_float2(cmul_re(a.x, a.y, b.x, b.y),
                            cmul_im(a.x, a.y, b.x, b.y)));
      c += N;
      o += plane;
    }
  }
}

// one block per (p, d) row
__global__ void __launch_bounds__(kThreads)
accum_kernel(const float2* __restrict__ corr, int N, int offset, int eff,
             int first, float* __restrict__ grid,
             float* __restrict__ row_max, int* __restrict__ row_arg) {
  __shared__ float sv[32];
  __shared__ int si[32];
  const size_t row = blockIdx.x;
  const float2* src = corr + row * N + offset;
  float* g = grid + row * eff;
  float best = -CUDART_INF_F;
  int arg = 0x7fffffff;
  for (int i = threadIdx.x; i < eff; i += blockDim.x) {
    const float2 v = src[i];
    float m = __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
    if (!first) m = __fadd_rn(g[i], m);
    g[i] = m;
    take_max(best, arg, m, i);
  }
  block_argmax(best, arg, sv, si);
  if (threadIdx.x == 0) {
    row_max[row] = best;
    row_arg[row] = arg;
  }
}

// ---- (c2) the statistics: one thread-block cluster per PRN ----------
//
// The peak row is the argmax over the D row peaks of (c1), taken by every
// warp with xor shuffles on (value, d) pairs under take_max's rule (the
// smallest d wins a tie; with the row's first argmax that is
// jnp.argmax's first flat index), so every thread holds it with no
// barrier. The row the statistic reads (the opposite row for CFAR, the
// peak row for the second peak) is cut over the cluster's S blocks
// (stats_slices: 1 at L1, 4 at E1, 3 at E5a): a head of up to 3 floats
// before its first 16-byte boundary (block 0), a body of 16-byte loads
// split into S contiguous parts, each thread issuing its kStatsLoads
// loads at once, a tail of up to 3 floats (block S - 1). Each block
// reduces its part: the CFAR sum, or the maximum outside the circular
// +-samples_per_chip exclusion around the peak (order-free, so equal to
// the plain version's to the bit). The other blocks' threads 0 write
// their parts into the leader's shared memory and arrive on its
// transaction barrier, then exit (no cluster-wide barrier at the end);
// the leader waits on it and adds the S sums in rank order (a fixed
// order: deterministic) or takes their maximum.
//
// Bound: a launch reads D row peaks and one row (16-64 KB at the search
// shapes, 0.04-0.5 us of bytes), so it costs its launch and two
// dependent memory latencies (the row peaks, then the row): the design
// keeps every thread's loads of the row in flight at once and leaves no
// serial loop over rows or samples.

// Floats of the row a block reads: 4 float4 loads a thread at 256
// threads. A cluster of one block (L1) skips the exchange, which costs
// more than its loads; halving the slice did not pay at E1 or E5a.
constexpr int kStatsSlice = 4096;

__host__ __device__ inline int stats_slices(int eff) {
  const int s = (eff + kStatsSlice - 1) / kStatsSlice;
  return s < 1 ? 1 : (s > kPortableCluster ? kPortableCluster : s);
}

// Loads a thread issues before it uses the first: a loop over rows or
// floats that waited on each load in turn took one memory latency a step.
constexpr int kStatsLoads = 4;

// argmax of rm[0 .. D) over the warp, every lane holding the result
__device__ __forceinline__ void warp_argmax(const float* __restrict__ rm,
                                            int D, float& v, int& d) {
  v = -CUDART_INF_F;
  d = 0x7fffffff;
  for (int i0 = threadIdx.x & 31; i0 < D; i0 += 32 * kStatsLoads) {
    float x[kStatsLoads];
#pragma unroll
    for (int u = 0; u < kStatsLoads; ++u)
      x[u] = i0 + 32 * u < D ? rm[i0 + 32 * u] : -CUDART_INF_F;
#pragma unroll
    for (int u = 0; u < kStatsLoads; ++u)
      if (i0 + 32 * u < D) take_max(v, d, x[u], i0 + 32 * u);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, off);
    const int d2 = __shfl_xor_sync(0xffffffffu, d, off);
    take_max(v, d, v2, d2);
  }
}

// the block's maximum of m (valid in thread 0; every m >= 0)
__device__ __forceinline__ float block_max(float m, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) scratch[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < n_warps ? scratch[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  return m;
}

// x where it lies outside the exclusion zone around bt, else 0
__device__ __forceinline__ float outside(float x, int i, int bt, int eff,
                                         int spc) {
  int dist = abs(i - bt);
  dist = min(dist, eff - dist);
  return dist > spc ? x : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
stats_kernel(const float* __restrict__ grid,
             const float* __restrict__ row_max,
             const int* __restrict__ row_arg, int D, int eff,
             float num_dwells, int samples_per_chip, int use_cfar,
             float* __restrict__ stat, int* __restrict__ index_doppler,
             int* __restrict__ index_time) {
  __shared__ float scratch[32];
  __shared__ float part[kPortableCluster];   // the leader's
  __shared__ uint64_t parts_in;   // the leader's: the S - 1 other parts
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  if (r == 0 && threadIdx.x == 0 && S > 1) mbar_init(&parts_in, S - 1);
  cluster_arrive_relaxed();   // this block runs (waited for below)
  const int p = blockIdx.x / S;
  const int tid = threadIdx.x, nt = blockDim.x;
  float peak;
  int bd;
  warp_argmax(row_max + (size_t)p * D, D, peak, bd);
  const int bt = row_arg[(size_t)p * D + bd];
  const float* row =
      grid + ((size_t)p * D + (use_cfar ? (bd + D / 2) % D : bd)) * eff;
  const int head = min(
      eff, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(row) & 15))
                            & 15) >> 2);
  const int n4 = (eff - head) >> 2;
  const int tail0 = head + 4 * n4;   // the tail: tail0 .. eff - 1
  const int per = (n4 + S - 1) / S;
  const int q0 = min(n4, r * per), q1 = min(n4, q0 + per);
  const float4* body = reinterpret_cast<const float4*>(row + head);
  float v = 0.0f;
  if (use_cfar) {
    for (int b = q0 + tid; b < q1; b += kStatsLoads * nt) {
      float4 x[kStatsLoads];
#pragma unroll
      for (int u = 0; u < kStatsLoads; ++u)
        x[u] = b + u * nt < q1 ? body[b + u * nt] : make_float4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < kStatsLoads; ++u)
        v = __fadd_rn(v, __fadd_rn(__fadd_rn(x[u].x, x[u].y),
                                   __fadd_rn(x[u].z, x[u].w)));
    }
    if (r == 0 && tid < head) v = __fadd_rn(v, row[tid]);
    if (r == S - 1 && tail0 + tid < eff) v = __fadd_rn(v, row[tail0 + tid]);
    float acc[1] = {v};
    block_sum<1>(acc, scratch);
    v = acc[0];
  } else {
    const int spc = samples_per_chip;
    for (int b = q0 + tid; b < q1; b += kStatsLoads * nt) {
      float4 x[kStatsLoads];
#pragma unroll
      for (int u = 0; u < kStatsLoads; ++u)
        x[u] = b + u * nt < q1 ? body[b + u * nt] : make_float4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < kStatsLoads; ++u) {
        const int i = head + 4 * (b + u * nt);
        v = fmaxf(v, fmaxf(fmaxf(outside(x[u].x, i, bt, eff, spc),
                                 outside(x[u].y, i + 1, bt, eff, spc)),
                           fmaxf(outside(x[u].z, i + 2, bt, eff, spc),
                                 outside(x[u].w, i + 3, bt, eff, spc))));
      }
    }
    if (r == 0 && tid < head)
      v = fmaxf(v, outside(row[tid], tid, bt, eff, spc));
    if (r == S - 1 && tail0 + tid < eff)
      v = fmaxf(v, outside(row[tail0 + tid], tail0 + tid, bt, eff, spc));
    v = block_max(v, scratch);
  }
  float* lead_part = cluster.map_shared_rank(part, 0);
  // every block of the cluster runs: the leader's memory and barrier
  cluster_wait();
  if (tid != 0) return;
  if (r != 0) {   // the part into the leader's memory; it need not wait
    lead_part[r] = v;
    mbar_arrive_remote(&parts_in, 0);
    return;
  }
  if (S > 1) mbar_wait(&parts_in, 0);
  float tot = v;
  for (int s = 1; s < S; ++s)
    tot = use_cfar ? __fadd_rn(tot, part[s]) : fmaxf(tot, part[s]);
  const float tiny = 1.17549435e-38f;
  if (use_cfar) {
    const float input_power =
        tot / static_cast<float>(eff) / 2.0f / num_dwells;
    stat[p] = peak / fmaxf(input_power, tiny);
  } else {
    stat[p] = peak / fmaxf(tot, tiny);
  }
  index_doppler[p] = bd;
  index_time[p] = bt;
}

// An empty kernel launched as stats_kernel is: the launch's own device
// time, the practical floor under K2d's.
__global__ void __launch_bounds__(kThreads) stats_empty_kernel() {}

// An empty kernel launched as wipeoff_fold_kernel is: the launch's own
// device time, the practical floor under K2a's and K5a's.
__global__ void __launch_bounds__(kWipeThreads) wipeoff_empty_kernel() {}

}  // namespace

extern "C" {

// (a) the S = 1 instance of wipeoff.cuh's body.
int acq_wipeoff(const float* x, const float* dopplers, float c0, int N,
                int D, float* out, void* stream) {
  return wipeoff_fold_launch<1>(x, dopplers, c0, 1, N, D, out, stream);
}

// The empty kernel in the launch configuration of a wipe-off (acq_wipeoff
// or fold_wipeoff) of D bins into rows of NF outputs (``aligned``: x and
// the output 16-byte aligned, as wipeoff_shape takes it).
int wipeoff_empty(int NF, int D, int aligned, void* stream) {
  if (NF < 1 || D < 1 || D / 2 + 1 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const WipeoffShape L = wipeoff_shape(aligned != 0, NF, D, wipeoff_sms());
  wipeoff_empty_kernel<<<L.grid, kWipeThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// That launch configuration on the current card: shape = {grid columns,
// grid rows, threads a block, 1 if a thread takes a pair of outputs}.
int wipeoff_launch_shape(int NF, int D, int aligned, int* shape) {
  const WipeoffShape L = wipeoff_shape(aligned != 0, NF, D, wipeoff_sms());
  shape[0] = static_cast<int>(L.grid.x);
  shape[1] = static_cast<int>(L.grid.y);
  shape[2] = kWipeThreads;
  shape[3] = L.pairs ? 1 : 0;
  return 0;
}

// (b) on pairs of samples when N is even and spec, code and out are
// 16-byte aligned, else on single samples.
int acq_product(const float* spec, const float* code, int N, int D, int P,
                float* out, void* stream) {
  if (N < 1 || D < 1 || P < 1 || D > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool pairs = N % 2 == 0 &&
      ((reinterpret_cast<uintptr_t>(spec) | reinterpret_cast<uintptr_t>(code) |
        reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int per_row = pairs ? N / 2 : N;
  const dim3 grid((per_row + kThreads - 1) / kThreads, D);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* sv = reinterpret_cast<const float2*>(spec);
  const auto* cv = reinterpret_cast<const float2*>(code);
  auto* ov = reinterpret_cast<float2*>(out);
  if (pairs)
    product_kernel<true><<<grid, kThreads, 0, s>>>(sv, cv, N, D, P, ov);
  else
    product_kernel<false><<<grid, kThreads, 0, s>>>(sv, cv, N, D, P, ov);
  return static_cast<int>(cudaGetLastError());
}

int acq_accum(const float* corr, int rows, int N, int offset, int eff,
              int first, float* grid, float* row_max, int* row_arg,
              void* stream) {
  accum_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(corr), N, offset, eff, first, grid,
      row_max, row_arg);
  return static_cast<int>(cudaGetLastError());
}

int acq_stats(const float* grid, const float* row_max, const int* row_arg,
              int P, int D, int eff, float num_dwells, int samples_per_chip,
              int use_cfar, float* stat, int* index_doppler,
              int* index_time, void* stream) {
  if (P < 1 || D < 1 || eff < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return cluster_launch(stats_kernel, P, stats_slices(eff), kThreads, 0,
                        static_cast<cudaStream_t>(stream), grid, row_max,
                        row_arg, D, eff, num_dwells, samples_per_chip,
                        use_cfar, stat, index_doppler, index_time);
}

// The empty kernel in acq_stats's launch configuration.
int acq_stats_empty(int P, int eff, void* stream) {
  return cluster_launch(stats_empty_kernel, P, stats_slices(eff), kThreads,
                        0, static_cast<cudaStream_t>(stream));
}

// acq_stats's cluster for rows of eff floats: its size S and
// cudaOccupancyMaxActiveClusters on the current card.
int acq_stats_cluster(int eff, int* S, int* n_active) {
  *S = stats_slices(eff);
  return cluster_occupancy(stats_kernel, *S, kThreads, 0, n_active);
}

}  // extern "C"
