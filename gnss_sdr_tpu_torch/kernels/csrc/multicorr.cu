// K3: the scan engine's per-period multicorrelator.
//
// Replaces gnss_sdr_tpu/ops/correlator.py::multicorrelate as called from
// gnss_sdr_tpu/tracking/engine.py::TrackingEngine._build_block_step
// .scan_body (one call per PRN-period scan step, all channels and taps).
//
// For channel c and tap t it computes, over the valid prefix n < length[c]
// of the channel's window at base + start[c],
//   sum_n code[c, chip_t(n) mod L] * x[n] * e^{-j (rem_carr + carr_step*n)}
// the direct per-sample form of the segmented-sum correlator. Sample n
// belongs to chip c when a_c <= n < a_{c+1} with the segmented form's own
// boundaries a_c = ceil((c + rem - shift) / step) in float32: the first
// guess floor(step*n - rem + shift) is corrected against them, so both
// forms assign every sample at a chip edge to the same chip and differ
// only in summation order. Like the segmented form, which sums the chips
// -n_extra .. code_len + n_extra - 1 only, a sample whose unwrapped chip
// lies outside that range is skipped for that tap (it matters only for
// windows longer than code_len + 2 n_extra chips).
//
// Bound: at the L1 shapes (8 channels x 4016 samples) the work is a few
// hundred kilobytes and ~1 MFLOP; at the Galileo E1 shapes (8 channels x
// 16016 samples, 5 taps on 49104-entry CBOC sub-chip tables) it is the
// 1.6 MB of tables and ~3 MFLOP. Either way a launch is bound by its
// launch latency, not by bytes or operations. Design: one block per
// channel, the code table in shared memory (no per-sample global gather;
// a 196 KB E1 table takes the opt-in dynamic shared memory above 48 KB),
// the int8 ring widened in the load (no dequantized copy), one sincosf
// per sample shared by all taps, and a single block reduction at the end.
// The E1 data-component prompt is a second launch on the same windows:
// the pilot and data tables do not fit one block's 227 KB together. The
// per-window body is corr_common.cuh's k3_accumulate, which the scan
// engine's fused kernel (scan_loop.cu) shares.
#include "corr_common.cuh"

namespace {

constexpr int kThreads = 256;
// dynamic shared memory a launch gets without opting in
constexpr size_t kDefaultSmem = 48 * 1024;

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
multicorr_kernel(const T* __restrict__ src_re, const T* __restrict__ src_im,
                 long long base, const int* __restrict__ start,
                 const int* __restrict__ length,
                 const float* __restrict__ code, int code_len,
                 const float* __restrict__ shifts,
                 const float* __restrict__ rem_code,
                 const float* __restrict__ code_step,
                 const float* __restrict__ rem_carr,
                 const float* __restrict__ carr_step, int max_period,
                 int n_extra, float* __restrict__ out_re,
                 float* __restrict__ out_im) {
  extern __shared__ float s_code[];
  __shared__ float scratch[2 * NT * 32];
  const int c = blockIdx.x;
  for (int i = threadIdx.x; i < code_len; i += blockDim.x)
    s_code[i] = code[(size_t)c * code_len + i];
  __syncthreads();

  float sh[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) sh[t] = shifts[t];
  float acc[2 * NT];
  k3_accumulate<T, NT, 0>(src_re, src_im, base + start[c],
                          min(length[c], max_period), s_code, code_len, sh,
                          n_extra, nullptr, 0, 0, rem_code[c], code_step[c],
                          rem_carr[c], carr_step[c], acc, threadIdx.x,
                          blockDim.x);
  block_sum<2 * NT>(acc, scratch);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      out_re[c * NT + t] = acc[t];
      out_im[c * NT + t] = acc[NT + t];
    }
  }
}

template <typename T>
int launch(const T* re, const T* im, long long base, const int* start,
           const int* length, const float* code, int code_len,
           const float* shifts, int n_taps, const float* rem_code,
           const float* code_step, const float* rem_carr,
           const float* carr_step, int max_period, int n_extra,
           float* out_re, float* out_im, int n_channels,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * code_len;
  const dim3 grid(n_channels), block(kThreads);
#define K3_CASE(NT)                                                        \
  case NT:                                                                 \
    if (smem > kDefaultSmem) {                                             \
      const cudaError_t e = cudaFuncSetAttribute(                          \
          multicorr_kernel<T, NT>,                                         \
          cudaFuncAttributeMaxDynamicSharedMemorySize,                     \
          static_cast<int>(smem));                                         \
      if (e != cudaSuccess) return static_cast<int>(e);                    \
    }                                                                      \
    multicorr_kernel<T, NT><<<grid, block, smem, stream>>>(                \
        re, im, base, start, length, code, code_len, shifts, rem_code,     \
        code_step, rem_carr, carr_step, max_period, n_extra, out_re,       \
        out_im);                                                           \
    break;
  switch (n_taps) {
    K3_CASE(1)
    K3_CASE(3)
    K3_CASE(5)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K3_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// int8 planar ring (re plane, im plane); widening folded into the load.
int multicorr_i8(const int8_t* re, const int8_t* im, long long base,
                 const int* start, const int* length, const float* code,
                 int code_len, const float* shifts, int n_taps,
                 const float* rem_code, const float* code_step,
                 const float* rem_carr, const float* carr_step,
                 int max_period, int n_extra, float* out_re, float* out_im,
                 int n_channels, void* stream) {
  return launch<int8_t>(re, im, base, start, length, code, code_len, shifts,
                        n_taps, rem_code, code_step, rem_carr, carr_step,
                        max_period, n_extra, out_re, out_im, n_channels,
                        static_cast<cudaStream_t>(stream));
}

// float32 planar block (process_block path).
int multicorr_f32(const float* re, const float* im, long long base,
                  const int* start, const int* length, const float* code,
                  int code_len, const float* shifts, int n_taps,
                  const float* rem_code, const float* code_step,
                  const float* rem_carr, const float* carr_step,
                  int max_period, int n_extra, float* out_re,
                  float* out_im, int n_channels, void* stream) {
  return launch<float>(re, im, base, start, length, code, code_len, shifts,
                       n_taps, rem_code, code_step, rem_carr, carr_step,
                       max_period, n_extra, out_re, out_im, n_channels,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
