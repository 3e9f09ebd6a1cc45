// K2: the PCPS acquisition grid around cuFFT.
//
// Replaces gnss_sdr_tpu/acquisition/pcps.py::_pcps_magnitude_grid with
// _cfar_statistics / _second_peak_statistics and the dwell sum of
// PcpsAcquisition.search. The transforms are torch.fft (cuFFT) calls in
// the wrapper; these kernels are the parts around them:
//   (a) acq_wipeoff: x[n] e^{j c0 f_d n} for every Doppler bin -> [D, N]
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
// they need.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void wipeoff_kernel(const float2* __restrict__ x,
                               const float* __restrict__ dopplers, float c0,
                               int N, int D, float2* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)D * N) return;
  const int d = static_cast<int>(i / N);
  const int n = static_cast<int>(i % N);
  const float ph = __fmul_rn(__fmul_rn(c0, dopplers[d]), static_cast<float>(n));
  float s, c;
  sincosf(ph, &s, &c);
  const float2 v = x[n];
  out[i] = make_float2(__fsub_rn(__fmul_rn(v.x, c), __fmul_rn(v.y, s)),
                       __fadd_rn(__fmul_rn(v.x, s), __fmul_rn(v.y, c)));
}

__global__ void product_kernel(const float2* __restrict__ spec,
                               const float2* __restrict__ code, int N, int D,
                               int P, float2* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)P * D * N) return;
  const int n = static_cast<int>(i % N);
  const size_t pd = i / N;
  const int d = static_cast<int>(pd % D);
  const int p = static_cast<int>(pd / D);
  const float2 a = spec[(size_t)d * N + n];
  const float2 b = code[(size_t)p * N + n];
  out[i] = make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                       __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
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

// one block per PRN
__global__ void __launch_bounds__(kThreads)
stats_kernel(const float* __restrict__ grid,
             const float* __restrict__ row_max,
             const int* __restrict__ row_arg, int D, int eff,
             float num_dwells, int samples_per_chip, int use_cfar,
             float* __restrict__ stat, int* __restrict__ index_doppler,
             int* __restrict__ index_time) {
  __shared__ float s_acc[32];
  __shared__ int s_best;
  const int p = blockIdx.x;
  if (threadIdx.x == 0) {
    // rows in order: the smallest Doppler index wins a tie, which with
    // the row's first argmax is jnp.argmax's first flat index
    int bd = 0;
    float bv = row_max[(size_t)p * D];
    for (int d = 1; d < D; ++d) {
      const float v = row_max[(size_t)p * D + d];
      if (v > bv) {
        bv = v;
        bd = d;
      }
    }
    s_best = bd;
  }
  __syncthreads();
  const int bd = s_best;
  const float peak = row_max[(size_t)p * D + bd];
  const int bt = row_arg[(size_t)p * D + bd];
  float v[1] = {0.0f};
  if (use_cfar) {
    const float* row = grid + ((size_t)p * D + (bd + D / 2) % D) * eff;
    for (int i = threadIdx.x; i < eff; i += blockDim.x) v[0] += row[i];
    block_sum<1>(v, s_acc);
  } else {
    const float* row = grid + ((size_t)p * D + bd) * eff;
    float m = 0.0f;
    for (int i = threadIdx.x; i < eff; i += blockDim.x) {
      int dist = abs(i - bt);
      dist = min(dist, eff - dist);
      const float x = dist > samples_per_chip ? row[i] : 0.0f;
      m = fmaxf(m, x);
    }
    // block max through the argmax helper (index unused)
    __shared__ float sv[32];
    __shared__ int si[32];
    int dummy = 0;
    block_argmax(m, dummy, sv, si);
    v[0] = m;
  }
  if (threadIdx.x == 0) {
    const float tiny = 1.17549435e-38f;
    float s;
    if (use_cfar) {
      const float input_power = v[0] / static_cast<float>(eff) / 2.0f
          / num_dwells;
      s = peak / fmaxf(input_power, tiny);
    } else {
      s = peak / fmaxf(v[0], tiny);
    }
    stat[p] = s;
    index_doppler[p] = bd;
    index_time[p] = bt;
  }
}

inline unsigned blocks_for(size_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int acq_wipeoff(const float* x, const float* dopplers, float c0, int N,
                int D, float* out, void* stream) {
  wipeoff_kernel<<<blocks_for((size_t)D * N), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(x), dopplers, c0, N, D,
      reinterpret_cast<float2*>(out));
  return static_cast<int>(cudaGetLastError());
}

int acq_product(const float* spec, const float* code, int N, int D, int P,
                float* out, void* stream) {
  product_kernel<<<blocks_for((size_t)P * D * N), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(spec),
      reinterpret_cast<const float2*>(code), N, D, P,
      reinterpret_cast<float2*>(out));
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
  stats_kernel<<<P, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      grid, row_max, row_arg, D, eff, num_dwells, samples_per_chip, use_cfar,
      stat, index_doppler, index_time);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
