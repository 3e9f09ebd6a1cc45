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
// they need. The product (b) writes P x D x N and reads D x N + P x N
// samples: a thread owns a pair of samples of one Doppler row, loads
// that row's pair once and walks the P code spectra (at most a few MB,
// held in L2), each pair moved as one 16-byte load or store.
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
  stats_kernel<<<P, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      grid, row_max, row_arg, D, eff, num_dwells, samples_per_chip, use_cfar,
      stat, index_doppler, index_time);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
