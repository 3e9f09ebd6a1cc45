// K1: the fast engine's code-bank group correlator.
//
// Replaces the bank branch of gnss_sdr_tpu/tracking/fast_engine.py
// ::FastTrackingEngine._build.group_body (window slices, carrier
// wipe-off, contraction with the [C, P+1, T, W] code bank and the linear
// interpolation between the two phase rows around the remnant code
// phase), and the data-code bank's prompt of a pilot-tracked channel
// (fast_engine.py:734-741): the wrapper's caller appends the data bank to
// the pilot bank as one more tap, so the data prompt reads the same
// rotated samples and the same rows j0 and j0+1. The secondary-code signs,
// the sum over K and the loop closure are the plain path's PyTorch (the
// fused fast_loop.cu runs them on the card).
//
// For each channel c, period k and tap t of one group:
//   a_j = sum_{n < n_eff} bank[c, j, t, n] * x[n] e^{-j(ph0[c,k] + step[c] n)}
//   corr = (1 - w[c,k]) * a_{j0[c,k]} + w[c,k] * a_{j0[c,k]+1}
// over the window of the int8 ring at base + win_start[c, k].
//
// The kernel reads the bank packed (kernels/bank_corr.py::pack_indices):
// [C, P+1, W] 32-bit words, tap t's entry a 4-bit index into a table of
// at most 16 float32 values, which gives back the float32 bank to the bit
// (the bank is a gather of a code table of a few levels).
//
// Bound: per group it must read C*K windows of int8 samples (2 bytes a
// sample) and the packed words of the rows the periods use (4 bytes a row
// and sample, whatever T); at C=8, K=20, T=3 (GPS L1) that is ~1.5 MB,
// ~0.5 us at 3.35 TB/s, against ~20 MFLOP (~0.3 us at 67 TFLOP/s); at
// C=8, K=25, T=5+1 (Galileo E1 pilot + data, n_eff=16001) ~7 MB against
// ~0.18 GFLOP (~2.7 us): bound by operations there, by bytes at L1. What
// holds it back is neither: a thread's samples form one chain of steps,
// each an accurate sincosf in its own divergence region, a table lookup
// and 4 FMAs a tap in the plain version's order, and 8-12 warps an SM
// do not hide the chain's latencies (tools/k1_split.py splits it). Design:
// one block per (channel, period), each thread the samples tid, tid +
// 256, ... in order (the sum order of every earlier K1, so the
// correlations stay what they were to the bit); the next kK1Batch
// samples' int8 pairs and packed words loaded while the current ones are
// summed, a whole batch's sincosf first and then its sums as one stretch
// of code (corr_common.cuh::k1_accumulate, k1_batch), the value table
// staged in shared memory while the first loads are on their way, only
// rows j0 and j0+1 read (the TPU form contracted all 17), one sincosf per
// sample shared by all taps, the bank's zero tail (columns >= n_eff)
// never read. The per-window body is corr_common.cuh's k1_accumulate +
// k1_interp, which the fast engine's fused kernel (fast_loop.cu) shares.
#include "corr_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
bank_corr_kernel(const T* __restrict__ src_re, const T* __restrict__ src_im,
                 long long base, const int* __restrict__ win_start,
                 const float* __restrict__ ph0,
                 const float* __restrict__ step,
                 const uint32_t* __restrict__ words,
                 const float* __restrict__ values,
                 const int* __restrict__ j0, const float* __restrict__ w,
                 int K, int P1, int W, int n_eff,
                 float* __restrict__ out_re, float* __restrict__ out_im) {
  __shared__ float scratch[4 * NT * 32];
  __shared__ float vals[kK1Values];
  const int ck = blockIdx.x;
  const int c = ck / K;
  const uint32_t* b0 = words + ((size_t)c * P1 + j0[ck]) * (size_t)W;
  // acc: [0,NT) a0 re, [NT,2NT) a0 im, [2NT,3NT) a1 re, [3NT,4NT) a1 im
  float acc[4 * NT];
  k1_accumulate<T, NT, true>(src_re, src_im, base + win_start[ck], ph0[ck],
                             step[c], b0, b0 + W, values, vals, n_eff, acc,
                             threadIdx.x, blockDim.x);
  block_sum<4 * NT>(acc, scratch);
  if (threadIdx.x == 0)
    k1_interp<NT>(acc, w[ck], out_re + ck * NT, out_im + ck * NT);
}

// an empty kernel launched as K1 is: the floor of a launch of its grid
__global__ void __launch_bounds__(kThreads) bank_corr_empty_kernel() {}

template <typename T>
int launch(const T* re, const T* im, long long base, const int* win_start,
           const float* ph0, const float* step, const uint32_t* words,
           const float* values, const int* j0, const float* w, int C, int K,
           int P1, int n_taps, int W, int n_eff, float* out_re,
           float* out_im, cudaStream_t stream) {
  const dim3 grid(C * K), block(kThreads);
#define K1_CASE(NT)                                                        \
  case NT:                                                                 \
    bank_corr_kernel<T, NT><<<grid, block, 0, stream>>>(                   \
        re, im, base, win_start, ph0, step, words, values, j0, w, K, P1,   \
        W, n_eff, out_re, out_im);                                         \
    break;
  switch (n_taps) {
    K1_CASE(1)
    K1_CASE(3)
    K1_CASE(4)
    K1_CASE(5)
    K1_CASE(6)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K1_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int bank_corr_i8(const int8_t* re, const int8_t* im, long long base,
                 const int* win_start, const float* ph0, const float* step,
                 const uint32_t* words, const float* values, const int* j0,
                 const float* w, int C, int K, int P1, int n_taps, int W,
                 int n_eff, float* out_re, float* out_im, void* stream) {
  return launch<int8_t>(re, im, base, win_start, ph0, step, words, values,
                        j0, w, C, K, P1, n_taps, W, n_eff, out_re, out_im,
                        static_cast<cudaStream_t>(stream));
}

int bank_corr_f32(const float* re, const float* im, long long base,
                  const int* win_start, const float* ph0, const float* step,
                  const uint32_t* words, const float* values, const int* j0,
                  const float* w, int C, int K, int P1, int n_taps, int W,
                  int n_eff, float* out_re, float* out_im, void* stream) {
  return launch<float>(re, im, base, win_start, ph0, step, words, values,
                       j0, w, C, K, P1, n_taps, W, n_eff, out_re, out_im,
                       static_cast<cudaStream_t>(stream));
}

int bank_corr_empty(int blocks, void* stream) {
  bank_corr_empty_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
