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
// launch latency and the per-sample latency of one window, not by bytes
// or operations. Design: one thread-block cluster per channel, the
// window cut into S slices of ceil(max_period / S) samples (S =
// corr_common.cuh::k3_slices(max_period), 8 at the L1 and E1 widths),
// one block a slice; each block holds the code table in shared memory
// (no per-sample global gather; a 196 KB E1 table takes the opt-in
// dynamic shared memory above 48 KB), reduces its slice over its 256
// threads, and the cluster's leader adds the S slice sums in slice order
// through distributed shared memory. K3-loop (scan_loop.cu) cuts every
// period's window the same way, so its correlations stay equal to K3's.
// The int8 ring is widened in the load (no dequantized copy), and one
// sincosf per sample is shared by all taps.
// The E1 data-component prompt is a second launch on the same windows:
// the pilot and data tables do not fit one block's 227 KB together. The
// per-window body is corr_common.cuh's k3_accumulate, which the scan
// engine's fused kernel (scan_loop.cu) shares.
//
// K3-hd (multicorr_hd_kernel) replaces multicorrelate's high-dynamics
// branch (gnss_sdr_tpu/ops/correlator.py:67-78, the library API's form
// with code_phase_rate_step; no engine passes it): the direct per-sample
// gather at the quadratic code phase
//   idx = floor(step n - rem + 0.5 rate n n + shift) mod code_len
// with the carrier rem_carr + carr_step n + 0.5 carr_rate n n, over the
// valid prefix n < length. The phases are rounded as the plain version
// (ops/correlator.py::multicorrelate_hd) rounds them, which is how XLA's
// CPU backend evaluates the JAX expression: two fused multiply-adds,
// fma((0.5 rate) n, n, fma(step, n, -rem)), each formed in float64 and
// rounded once to float32 (fma_f64 below). n n is never formed as an
// integer square: JAX's n is float32, inexact in n n past n = 4096, and
// at E1's three table entries a sample one ulp moves chip edges. The
// layout: one block per channel, the table in
// shared memory (opted in above 48 KB for E1's 49104 entries), one
// sincosf a sample for all taps. Bound: the windows and tables once, a
// few hundred kilobytes at C = 8; a launch costs its latency.
#include "corr_common.cuh"

namespace {

constexpr int kThreads = 256;

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
  constexpr int NA = 2 * NT;
  extern __shared__ float s_code[];
  __shared__ float scratch[NA * 32];
  __shared__ float part[kPortableCluster * NA];   // the leader's
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.x / S;
  for (int i = threadIdx.x; i < code_len; i += blockDim.x)
    s_code[i] = code[(size_t)c * code_len + i];
  __syncthreads();

  float sh[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) sh[t] = shifts[t];
  const int ls = k3_slice_len(max_period, S);
  const int len = min(length[c], max_period);
  float acc[NA];
  k3_accumulate<T, NT, 0>(src_re, src_im, base + start[c], r * ls,
                          min(len, (r + 1) * ls), s_code, code_len, sh,
                          n_extra, nullptr, 0, 0, rem_code[c], code_step[c],
                          rem_carr[c], carr_step[c], acc, threadIdx.x,
                          blockDim.x);
  block_sum<NA>(acc, scratch);
  float* lead_part = cluster.map_shared_rank(part, 0);
  cluster.sync();   // every block of the cluster runs: the leader's memory
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NA; ++i) lead_part[r * NA + i] = acc[i];
  }
  cluster.sync();   // every slice's sums with the leader
  if (r == 0 && threadIdx.x == 0) {
    float tot[NA];
    slice_total<NA>(part, S, tot);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      out_re[c * NT + t] = tot[t];
      out_im[c * NT + t] = tot[NT + t];
    }
  }
}

// a * b + c rounded once to float32 through float64 (the product of two
// float32 values is exact there), as the plain version forms it
__device__ __forceinline__ float fma_f64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(
      __dmul_rn(static_cast<double>(a), static_cast<double>(b)),
      static_cast<double>(c)));
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
multicorr_hd_kernel(const T* __restrict__ src_re,
                    const T* __restrict__ src_im, long long base,
                    const int* __restrict__ start,
                    const int* __restrict__ length,
                    const float* __restrict__ code, int code_len,
                    const float* __restrict__ shifts,
                    const float* __restrict__ rem_code,
                    const float* __restrict__ code_step,
                    const float* __restrict__ code_rate,
                    const float* __restrict__ rem_carr,
                    const float* __restrict__ carr_step,
                    const float* __restrict__ carr_rate, int max_period,
                    float* __restrict__ out_re, float* __restrict__ out_im) {
  extern __shared__ float s_code[];
  __shared__ float scratch[2 * NT * 32];
  const int c = blockIdx.x;
  for (int i = threadIdx.x; i < code_len; i += blockDim.x)
    s_code[i] = code[(size_t)c * code_len + i];
  __syncthreads();

  float sh[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) sh[t] = shifts[t];
  const float rc = rem_code[c], cs = code_step[c];
  const float hc = __fmul_rn(0.5f, code_rate[c]);
  const float rp = rem_carr[c], ps = carr_step[c];
  // no carrier rate: + 0 leaves the linear phase as it is
  const float hp = carr_rate ? __fmul_rn(0.5f, carr_rate[c]) : 0.0f;
  const float mrc = -rc;
  const int len = min(length[c], max_period);
  const long long s0 = base + start[c];
  float acc[2 * NT];
#pragma unroll
  for (int i = 0; i < 2 * NT; ++i) acc[i] = 0.0f;
  for (int n = threadIdx.x; n < len; n += blockDim.x) {
    const float fn = static_cast<float>(n);
    const float phase = fma_f64(__fmul_rn(hp, fn), fn, fma_f64(ps, fn, rp));
    float rr, ri;
    derotate(to_f32(src_re[s0 + n]), to_f32(src_im[s0 + n]), phase, rr, ri);
    const float cp = fma_f64(__fmul_rn(hc, fn), fn, fma_f64(cs, fn, mrc));
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      int idx = static_cast<int>(floorf(__fadd_rn(cp, sh[t]))) % code_len;
      if (idx < 0) idx += code_len;
      const float q = s_code[idx];
      acc[t] = __fmaf_rn(q, rr, acc[t]);
      acc[NT + t] = __fmaf_rn(q, ri, acc[NT + t]);
    }
  }
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
int launch_hd(const T* re, const T* im, long long base, const int* start,
              const int* length, const float* code, int code_len,
              const float* shifts, int n_taps, const float* rem_code,
              const float* code_step, const float* code_rate,
              const float* rem_carr, const float* carr_step,
              const float* carr_rate, int max_period, float* out_re,
              float* out_im, int n_channels, cudaStream_t stream) {
  const size_t smem = sizeof(float) * code_len;
  const dim3 grid(n_channels), block(kThreads);
#define K3HD_CASE(NT)                                                      \
  case NT:                                                                 \
    if (smem > kSmemNoOptIn) {                                             \
      const cudaError_t e = cudaFuncSetAttribute(                          \
          multicorr_hd_kernel<T, NT>,                                      \
          cudaFuncAttributeMaxDynamicSharedMemorySize,                     \
          static_cast<int>(smem));                                         \
      if (e != cudaSuccess) return static_cast<int>(e);                    \
    }                                                                      \
    multicorr_hd_kernel<T, NT><<<grid, block, smem, stream>>>(             \
        re, im, base, start, length, code, code_len, shifts, rem_code,     \
        code_step, code_rate, rem_carr, carr_step, carr_rate, max_period,  \
        out_re, out_im);                                                   \
    break;
  switch (n_taps) {
    K3HD_CASE(1)
    K3HD_CASE(3)
    K3HD_CASE(5)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K3HD_CASE
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
using K3Kernel = void (*)(const T*, const T*, long long, const int*,
                          const int*, const float*, int, const float*,
                          const float*, const float*, const float*,
                          const float*, int, int, float*, float*);

template <typename T>
K3Kernel<T> k3_kernel(int n_taps) {
  switch (n_taps) {
    case 1: return multicorr_kernel<T, 1>;
    case 3: return multicorr_kernel<T, 3>;
    case 5: return multicorr_kernel<T, 5>;
    default: return nullptr;
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
  const K3Kernel<T> kern = k3_kernel<T>(n_taps);
  if (kern == nullptr || max_period < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return cluster_launch(kern, n_channels, k3_slices(max_period), kThreads,
                        sizeof(float) * code_len, stream, re, im, base,
                        start, length, code, code_len, shifts, rem_code,
                        code_step, rem_carr, carr_step, max_period, n_extra,
                        out_re, out_im);
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

// K3-hd on the int8 ring / float32 planes; carr_rate may be null (a
// linear carrier).
int multicorr_hd_i8(const int8_t* re, const int8_t* im, long long base,
                    const int* start, const int* length, const float* code,
                    int code_len, const float* shifts, int n_taps,
                    const float* rem_code, const float* code_step,
                    const float* code_rate, const float* rem_carr,
                    const float* carr_step, const float* carr_rate,
                    int max_period, float* out_re, float* out_im,
                    int n_channels, void* stream) {
  return launch_hd<int8_t>(re, im, base, start, length, code, code_len,
                           shifts, n_taps, rem_code, code_step, code_rate,
                           rem_carr, carr_step, carr_rate, max_period, out_re,
                           out_im, n_channels,
                           static_cast<cudaStream_t>(stream));
}

int multicorr_hd_f32(const float* re, const float* im, long long base,
                     const int* start, const int* length, const float* code,
                     int code_len, const float* shifts, int n_taps,
                     const float* rem_code, const float* code_step,
                     const float* code_rate, const float* rem_carr,
                     const float* carr_step, const float* carr_rate,
                     int max_period, float* out_re, float* out_im,
                     int n_channels, void* stream) {
  return launch_hd<float>(re, im, base, start, length, code, code_len,
                          shifts, n_taps, rem_code, code_step, code_rate,
                          rem_carr, carr_step, carr_rate, max_period, out_re,
                          out_im, n_channels,
                          static_cast<cudaStream_t>(stream));
}

// K3's cluster on the current card for a window of max_period samples:
// its size S (the window's slices) and cudaOccupancyMaxActiveClusters.
int multicorr_cluster(int n_taps, int code_len, int max_period, int i8,
                      int* S, int* n_active) {
  const int s = k3_slices(max_period);
  *S = s;
  const size_t smem = sizeof(float) * code_len;
  if (i8) {
    const K3Kernel<int8_t> kern = k3_kernel<int8_t>(n_taps);
    if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return cluster_occupancy(kern, s, kThreads, smem, n_active);
  }
  const K3Kernel<float> kern = k3_kernel<float>(n_taps);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return cluster_occupancy(kern, s, kThreads, smem, n_active);
}

}  // extern "C"
