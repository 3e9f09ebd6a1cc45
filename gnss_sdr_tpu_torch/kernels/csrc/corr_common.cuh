// The per-window correlation bodies of K3 (scan engine) and K1 (fast
// engine) as device functions.
//
// multicorr.cu and bank_corr.cu launch them one window per block;
// scan_loop.cu and fast_loop.cu call them inside their persistent loops.
// Every product and sum is rounded explicitly (__fmul_rn, __fmaf_rn, ...),
// so the compiler cannot contract them differently in the two contexts:
// with the same thread layout (the thread of index tid of nthreads takes
// the samples tid, tid + nthreads, ...) and the same block_sum, the fused
// kernels' correlations equal K3's and K1's to the bit.
#pragma once
#include "common.cuh"

// first sample of chip c: ceil((c + rem - shift) / step), rounded as the
// segmented-sum form rounds it
__device__ __forceinline__ float chip_start(int c, float rem, float shift,
                                            float step) {
  return ceilf(__fdiv_rn(__fsub_rn(__fadd_rn(static_cast<float>(c), rem),
                                   shift), step));
}

// The table index of the chip that holds sample n (as float fn) for a tap
// at ``shift``, with the segmented form's own chip boundaries; false for a
// sample whose unwrapped chip lies outside -n_extra .. code_len + n_extra
// - 1 (the segmented form sums those chips only).
__device__ __forceinline__ bool chip_of(float cp, float fn, float rc,
                                        float shift, float cs, int n_extra,
                                        int code_len, int& idx) {
  int i = static_cast<int>(floorf(__fadd_rn(cp, shift)));
  while (chip_start(i, rc, shift, cs) > fn) --i;
  while (chip_start(i + 1, rc, shift, cs) <= fn) ++i;
  if (i < -n_extra || i >= code_len + n_extra) return false;
  i %= code_len;
  if (i < 0) i += code_len;
  idx = i;
  return true;
}

// K3's body: this thread's partial sums over the valid prefix n < len of
// the window at s0. acc[t], acc[NT + t] are tap t's re, im (code table
// ``code`` of ``code_len`` entries, tap shifts ``sh``). With ND = 1 the
// data-component code ``dcode`` at zero shift rides on the same rotated
// samples (one sincosf for both): acc[2 NT], acc[2 NT + 1].
template <typename T, int NT, int ND>
__device__ __forceinline__ void k3_accumulate(
    const T* __restrict__ src_re, const T* __restrict__ src_im, long long s0,
    int len, const float* code, int code_len, const float (&sh)[NT],
    int n_extra, const float* dcode, int dcode_len, int n_extra_d, float rc,
    float cs, float rp, float ps, float (&acc)[2 * (NT + ND)], int tid,
    int nthreads) {
#pragma unroll
  for (int i = 0; i < 2 * (NT + ND); ++i) acc[i] = 0.0f;
  for (int n = tid; n < len; n += nthreads) {
    const float fn = static_cast<float>(n);
    float rr, ri;
    derotate(to_f32(src_re[s0 + n]), to_f32(src_im[s0 + n]),
             __fadd_rn(rp, __fmul_rn(ps, fn)), rr, ri);
    const float cp = __fsub_rn(__fmul_rn(cs, fn), rc);
    int idx;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (!chip_of(cp, fn, rc, sh[t], cs, n_extra, code_len, idx)) continue;
      const float q = code[idx];
      acc[t] = __fmaf_rn(q, rr, acc[t]);
      acc[NT + t] = __fmaf_rn(q, ri, acc[NT + t]);
    }
    if constexpr (ND == 1) {
      if (chip_of(cp, fn, rc, 0.0f, cs, n_extra_d, dcode_len, idx)) {
        const float q = dcode[idx];
        acc[2 * NT] = __fmaf_rn(q, rr, acc[2 * NT]);
        acc[2 * NT + 1] = __fmaf_rn(q, ri, acc[2 * NT + 1]);
      }
    }
  }
}

// K1's body: this thread's partial sums of the window at s0 (n < n_eff)
// rotated by ph0 + step n, against bank rows b0 (acc[0, 2 NT): re, im)
// and b1 (acc[2 NT, 4 NT)), each row NT taps of W columns.
template <typename T, int NT>
__device__ __forceinline__ void k1_accumulate(
    const T* __restrict__ src_re, const T* __restrict__ src_im, long long s0,
    float p0, float st, const float* __restrict__ b0,
    const float* __restrict__ b1, int W, int n_eff, float (&acc)[4 * NT],
    int tid, int nthreads) {
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) acc[i] = 0.0f;
  for (int n = tid; n < n_eff; n += nthreads) {
    float rr, ri;
    derotate(to_f32(src_re[s0 + n]), to_f32(src_im[s0 + n]),
             __fadd_rn(p0, __fmul_rn(st, static_cast<float>(n))), rr, ri);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float q0 = __ldg(b0 + (size_t)t * W + n);
      const float q1 = __ldg(b1 + (size_t)t * W + n);
      acc[t] = __fmaf_rn(q0, rr, acc[t]);
      acc[NT + t] = __fmaf_rn(q0, ri, acc[NT + t]);
      acc[2 * NT + t] = __fmaf_rn(q1, rr, acc[2 * NT + t]);
      acc[3 * NT + t] = __fmaf_rn(q1, ri, acc[3 * NT + t]);
    }
  }
}

// K1's interpolation between the two rows' sums (block-reduced acc):
// (1 - w) a0 + w a1, rounded as the plain version rounds it.
template <int NT>
__device__ __forceinline__ void k1_interp(const float (&acc)[4 * NT], float w,
                                          float* out_re, float* out_im) {
  const float wm = __fsub_rn(1.0f, w);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    out_re[t] = __fadd_rn(__fmul_rn(wm, acc[t]), __fmul_rn(w, acc[2 * NT + t]));
    out_im[t] = __fadd_rn(__fmul_rn(wm, acc[NT + t]),
                          __fmul_rn(w, acc[3 * NT + t]));
  }
}
