// K5: the acquisition variants' grid kernels around cuFFT.
//
//   (a) fold_wipeoff replaces the prologue of
//       gnss_sdr_tpu/acquisition/variants.py::_folded_grid (QuickSync): for
//       every Doppler bin d and folded index m < N/S it writes
//         out[d, m] = sum_{s < S} x[s N/S + m] e^{j c0 f_d (s N/S + m)},
//       c0 = -2 pi / fs, the carrier wiped off at the absolute sample
//       index before the S segments are summed (the carrier phase differs
//       between segments). The FFT, K2's product against the folded code
//       spectra, the inverse FFT and K2's |.|^2 and statistics follow.
//   (b) cccwsr_combine replaces the epilogue of
//       gnss_sdr_tpu/acquisition/variants.py::_cccwsr_grid (CCCWSR): from
//       the E1-B and E1-C correlations yb, yc [P, D, N] it writes
//       max(|yb + yc|^2, |yb - yc|^2) [P, D, N] with each row's peak and
//       first argmax, the inputs of K2's acq_stats.
//
// (a) is the body of wipeoff.cuh, shared with K2's wipe-off (its S = 1
// instance): see there for its bound and design. It writes the folded
// bins once, never the unfolded [D, N] product.
// (b) is a few flops per element of large grids (E1: 36 PRNs x 80 bins x
// 16000 samples, 368 MB per complex grid), so bytes bound it: it reads
// the two complex grids once and writes the real grid once with its row
// peaks in the same pass, every product and sum explicitly rounded (no
// FMA contraction), so it equals its plain version to the bit.
#include "common.cuh"
#include "wipeoff.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mag2(float re, float im) {
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

// one block per (p, d) row
__global__ void __launch_bounds__(kThreads)
cccwsr_combine_kernel(const float2* __restrict__ yb,
                      const float2* __restrict__ yc, int N,
                      float* __restrict__ grid, float* __restrict__ row_max,
                      int* __restrict__ row_arg) {
  __shared__ float sv[32];
  __shared__ int si[32];
  const size_t row = blockIdx.x;
  const float2* b = yb + row * N;
  const float2* c = yc + row * N;
  float* g = grid + row * N;
  float best = -CUDART_INF_F;
  int arg = 0x7fffffff;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const float2 u = b[i], v = c[i];
    const float plus = mag2(__fadd_rn(u.x, v.x), __fadd_rn(u.y, v.y));
    const float minus = mag2(__fsub_rn(u.x, v.x), __fsub_rn(u.y, v.y));
    const float m = fmaxf(plus, minus);
    g[i] = m;
    take_max(best, arg, m, i);
  }
  block_argmax(best, arg, sv, si);
  if (threadIdx.x == 0) {
    row_max[row] = best;
    row_arg[row] = arg;
  }
}

}  // namespace

extern "C" {

// (a) wipeoff.cuh's body: S = 1 (K2a's instance), 2 and 4 unrolled with
// the segments' samples in registers, any other S as a loop.
int fold_wipeoff(const float* x, const float* dopplers, float c0, int S,
                 int NF, int D, float* out, void* stream) {
  switch (S) {
    case 1:
      return wipeoff_fold_launch<1>(x, dopplers, c0, S, NF, D, out, stream);
    case 2:
      return wipeoff_fold_launch<2>(x, dopplers, c0, S, NF, D, out, stream);
    case 4:
      return wipeoff_fold_launch<4>(x, dopplers, c0, S, NF, D, out, stream);
    default:
      return wipeoff_fold_launch<0>(x, dopplers, c0, S, NF, D, out, stream);
  }
}

int cccwsr_combine(const float* yb, const float* yc, int rows, int N,
                   float* grid, float* row_max, int* row_arg, void* stream) {
  cccwsr_combine_kernel<<<rows, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(yb),
      reinterpret_cast<const float2*>(yc), N, grid, row_max, row_arg);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
