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
// at E1's three table entries a sample one ulp moves chip edges. Bound:
// the windows and tables once, a few hundred kilobytes at C = 8, so a
// launch costs its latency and one slice's serial work. The layout: one
// cluster of k3_slices(max_period) blocks a channel, cut as K3's; each
// block stages only the table entries its slice reaches (~6.2 K of E1's
// 49104 entries in a 32 KB buffer, so several blocks share an SM where
// the whole 196 KB table took one), loads kHdBatch samples a thread at
// once while the entries are copied, and shares one sincosf a sample
// among all taps.
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

// ---- K3-hd: one thread-block cluster per channel, as K3 -------------
//
// The window's valid prefix is cut into K3's slices (k3_slices,
// k3_slice_len), one block each. A block stages only the table entries
// its slice reaches: the code phase cp(n) = step n - rem + rate n^2 / 2
// is a quadratic, so over the slice its extremes lie at the slice's ends
// or at its vertex n* = -step / rate; that range, widened by the taps'
// span and kHdMargin entries for the float32 rounding of the phase, is
// copied (cp.async, wrapping mod code_len) into shared memory, indexed by
// the unwrapped entry. A slice whose range exceeds the launch's
// kHdStage-entry budget stages nothing, and a lookup outside the staged
// range (none when the range holds) reads the table in device memory
// (L2): one kernel, every index served. The slices' sums are added in
// slice order by the cluster's leader, as K3's.
constexpr int kHdStage = 8192;   // staged entries at most (32 KB)
constexpr int kHdMargin = 2;
constexpr int kHdBatch = 8;      // samples a thread loads at once

// The unwrapped table entries [lo, lo + W) that the code index
// floor(cp(n) + shift) reaches for n0 <= n < n1 (n1 > n0) and shifts in
// [sh_lo, sh_hi], with cp(n) = cs n + mrc + hc n^2; false when they are
// more than cap entries (or not finite).
__host__ __device__ inline bool hd_reach(float cs, float mrc, float hc,
                                         int n0, int n1, float sh_lo,
                                         float sh_hi, int cap, int& lo,
                                         int& W) {
  const double a = n0, b = n1 - 1, s = cs, m = mrc, h = hc;
  const double qa = (h * a + s) * a + m, qb = (h * b + s) * b + m;
  double q_lo = fmin(qa, qb), q_hi = fmax(qa, qb);
  if (h != 0.0) {
    const double v = -s / (2.0 * h);
    if (v > a && v < b) {
      const double qv = (h * v + s) * v + m;
      q_lo = fmin(q_lo, qv);
      q_hi = fmax(q_hi, qv);
    }
  }
  const double l = floor(q_lo + sh_lo) - kHdMargin;
  const double w = floor(q_hi + sh_hi) + kHdMargin - l + 1.0;
  if (!(w <= cap) || !(fabs(l) < 1e9)) return false;
  lo = static_cast<int>(l);
  W = static_cast<int>(w);
  return true;
}

// a 4-byte asynchronous copy from global to shared memory
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned int>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
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
                    int cap, float* __restrict__ out_re,
                    float* __restrict__ out_im) {
  constexpr int NA = 2 * NT;
  extern __shared__ float s_code[];
  __shared__ float scratch[NA * 32];
  __shared__ float part[kPortableCluster * NA];   // the leader's
  cluster_arrive_relaxed();   // this block runs (waited for below)
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.x / S;
  const int tid = threadIdx.x, nt = blockDim.x;

  float sh[NT];
  float sh_lo = shifts[0], sh_hi = shifts[0];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    sh[t] = shifts[t];
    sh_lo = fminf(sh_lo, sh[t]);
    sh_hi = fmaxf(sh_hi, sh[t]);
  }
  const float rc = rem_code[c], cs = code_step[c];
  const float hc = __fmul_rn(0.5f, code_rate[c]);
  const float rp = rem_carr[c], ps = carr_step[c];
  // no carrier rate: + 0 leaves the linear phase as it is
  const float hp = carr_rate ? __fmul_rn(0.5f, carr_rate[c]) : 0.0f;
  const float mrc = -rc;
  const int ls = k3_slice_len(max_period, S);
  const int len = min(length[c], max_period);
  const int n0 = r * ls, n1 = min(len, n0 + ls);
  const long long s0 = base + start[c];
  const float* table = code + (size_t)c * code_len;

  // the slice's table entries, copied while its first samples load
  int lo = 0, W = 0;
  if (n1 > n0 && !hd_reach(cs, mrc, hc, n0, n1, sh_lo, sh_hi, cap, lo, W))
    W = 0;
  if (W > 0) {
    int first = lo % code_len;
    if (first < 0) first += code_len;
    for (int j = tid; j < W; j += nt) {
      const int k = first + j;   // W <= cap <= code_len: one wrap at most
      cp_async4(s_code + j, table + (k < code_len ? k : k - code_len));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.0f;
  for (int b0 = n0; b0 < n1; b0 += kHdBatch * nt) {
    float xr[kHdBatch], xi[kHdBatch];
#pragma unroll
    for (int u = 0; u < kHdBatch; ++u) {
      const int n = b0 + u * nt + tid;
      xr[u] = n < n1 ? to_f32(src_re[s0 + n]) : 0.0f;
      xi[u] = n < n1 ? to_f32(src_im[s0 + n]) : 0.0f;
    }
    if (b0 == n0) {   // the staged entries, before the first lookup
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < kHdBatch; ++u) {
      const int n = b0 + u * nt + tid;
      if (n >= n1) break;
      const float fn = static_cast<float>(n);
      const float phase =
          fma_f64(__fmul_rn(hp, fn), fn, fma_f64(ps, fn, rp));
      float rr, ri;
      derotate(xr[u], xi[u], phase, rr, ri);
      const float cp = fma_f64(__fmul_rn(hc, fn), fn, fma_f64(cs, fn, mrc));
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int iu = static_cast<int>(floorf(__fadd_rn(cp, sh[t])));
        const unsigned j = static_cast<unsigned>(iu - lo);
        float q;
        if (j < static_cast<unsigned>(W)) {
          q = s_code[j];
        } else {
          int idx = iu % code_len;
          if (idx < 0) idx += code_len;
          q = __ldg(table + idx);
        }
        acc[t] = __fmaf_rn(q, rr, acc[t]);
        acc[NT + t] = __fmaf_rn(q, ri, acc[NT + t]);
      }
    }
  }
  block_sum<NA>(acc, scratch);
  float* lead_part = cluster.map_shared_rank(part, 0);
  cluster_wait();   // every block of the cluster runs: the leader's memory
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < NA; ++i) lead_part[r * NA + i] = acc[i];
  }
  cluster.sync();   // every slice's sums with the leader
  if (r == 0 && tid == 0) {
    float tot[NA];
    slice_total<NA>(part, S, tot);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      out_re[c * NT + t] = tot[t];
      out_im[c * NT + t] = tot[NT + t];
    }
  }
}

template <typename T>
using K3HdKernel = void (*)(const T*, const T*, long long, const int*,
                            const int*, const float*, int, const float*,
                            const float*, const float*, const float*,
                            const float*, const float*, const float*, int,
                            int, float*, float*);

template <typename T>
K3HdKernel<T> k3hd_kernel(int n_taps) {
  switch (n_taps) {
    case 1: return multicorr_hd_kernel<T, 1>;
    case 3: return multicorr_hd_kernel<T, 3>;
    case 5: return multicorr_hd_kernel<T, 5>;
    default: return nullptr;
  }
}

// the staged entries a block holds for tables of code_len entries
inline int hd_cap(int code_len) {
  return code_len < kHdStage ? code_len : kHdStage;
}

template <typename T>
int launch_hd(const T* re, const T* im, long long base, const int* start,
              const int* length, const float* code, int code_len,
              const float* shifts, int n_taps, const float* rem_code,
              const float* code_step, const float* code_rate,
              const float* rem_carr, const float* carr_step,
              const float* carr_rate, int max_period, float* out_re,
              float* out_im, int n_channels, cudaStream_t stream) {
  const K3HdKernel<T> kern = k3hd_kernel<T>(n_taps);
  if (kern == nullptr || max_period < 1 || code_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cap = hd_cap(code_len);
  return cluster_launch(kern, n_channels, k3_slices(max_period), kThreads,
                        sizeof(float) * cap, stream, re, im, base, start,
                        length, code, code_len, shifts, rem_code, code_step,
                        code_rate, rem_carr, carr_step, carr_rate,
                        max_period, cap, out_re, out_im);
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

// cluster_occupancy of the int8 (i8) or float32 form of a kernel; an
// unknown tap count (a null kernel) is refused
template <typename K8, typename KF>
int occupancy(K8* k8, KF* kf, int i8, int S, size_t smem, int* n_active) {
  if (k8 == nullptr || kf == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return i8 ? cluster_occupancy(k8, S, kThreads, smem, n_active)
            : cluster_occupancy(kf, S, kThreads, smem, n_active);
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
  *S = k3_slices(max_period);
  return occupancy(k3_kernel<int8_t>(n_taps), k3_kernel<float>(n_taps), i8,
                   *S, sizeof(float) * code_len, n_active);
}

// K3-hd's cluster on the current card, as multicorr_cluster's.
int multicorr_hd_cluster(int n_taps, int code_len, int max_period, int i8,
                         int* S, int* n_active) {
  *S = k3_slices(max_period);
  return occupancy(k3hd_kernel<int8_t>(n_taps), k3hd_kernel<float>(n_taps),
                   i8, *S, sizeof(float) * hd_cap(code_len), n_active);
}

}  // extern "C"
