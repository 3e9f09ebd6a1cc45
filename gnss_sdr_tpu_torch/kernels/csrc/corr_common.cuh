// The per-window correlation bodies of K3 (scan engine), K1 (fast
// engine, code bank) and K1-seg (fast engine, segmented sum) as device
// functions.
//
// multicorr.cu and bank_corr.cu launch K3's and K1's one window per block;
// scan_loop.cu and fast_loop.cu call them inside their persistent loops
// (K1-seg runs only there).
// Every product and sum is rounded explicitly (__fmul_rn, __fmaf_rn, ...),
// so the compiler cannot contract them differently in the two contexts:
// with the same thread layout (the thread of index tid of nthreads takes
// the samples tid, tid + nthreads, ...), the same block_sum and, for K3,
// the same partition of the window into slices summed in slice order
// (k3_slices, slice_total), the fused kernels' correlations equal K3's
// and K1's to the bit.
#pragma once
#include "cluster.cuh"
#include "common.cuh"

// ---- K3's window partition (multicorr.cu's K3, scan_loop.cu's K3-loop)
//
// A window of at most max_period samples is cut into S contiguous slices
// of ceil(max_period / S) samples, one block of a cluster each: S =
// ceil(max_period / kSliceMin), at most kPortableCluster (a slice of at
// least 512 samples keeps two strides of 256 threads busy, and a cluster
// of 8 blocks that each hold E1's 196 KB table fits a GPC twice, so 8
// channels' clusters run at once). The partition depends on max_period
// alone, never on the card, so K3 and K3-loop cut every window alike.
constexpr int kSliceMin = 512;

__host__ __device__ inline int k3_slices(int max_period) {
  const int s = (max_period + kSliceMin - 1) / kSliceMin;
  return s < 1 ? 1 : (s > kPortableCluster ? kPortableCluster : s);
}

__host__ __device__ inline int k3_slice_len(int max_period, int S) {
  return (max_period + S - 1) / S;
}

// The window's sums from its S slices' block sums (part[s NA + i]),
// added in slice order: K3 and K3-loop both form them so.
template <int NA>
__device__ __forceinline__ void slice_total(const float* part, int S,
                                            float (&tot)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) tot[i] = part[i];
  for (int s = 1; s < S; ++s) {
#pragma unroll
    for (int i = 0; i < NA; ++i) tot[i] = __fadd_rn(tot[i], part[s * NA + i]);
  }
}

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

// K3's body: this thread's partial sums over the samples n_lo <= n < n_hi
// of the window at s0 (a slice of its valid prefix; n counts from the
// window's start). acc[t], acc[NT + t] are tap t's re, im (code table
// ``code`` of ``code_len`` entries, tap shifts ``sh``). With ND = 1 the
// data-component code ``dcode`` at zero shift rides on the same rotated
// samples (one sincosf for both): acc[2 NT], acc[2 NT + 1].
template <typename T, int NT, int ND>
__device__ __forceinline__ void k3_accumulate(
    const T* __restrict__ src_re, const T* __restrict__ src_im, long long s0,
    int n_lo, int n_hi, const float* code, int code_len,
    const float (&sh)[NT],
    int n_extra, const float* dcode, int dcode_len, int n_extra_d, float rc,
    float cs, float rp, float ps, float (&acc)[2 * (NT + ND)], int tid,
    int nthreads) {
#pragma unroll
  for (int i = 0; i < 2 * (NT + ND); ++i) acc[i] = 0.0f;
  for (int n = n_lo + tid; n < n_hi; n += nthreads) {
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

// ---- K1-seg: the fast engine's segmented-sum correlator ----------------
//
// The plain version (tracking/fast_engine.py::segsum_corr, JAX's
// group_body after "segmented-sum correlation") prefix-sums the rotated
// group window and reads it at each tap's chip boundaries
//   a_i = clip(ceil(r0 + (i - shift) / step), 0, lg),  i = -1 .. K Q + 1,
// so chip i of a tap holds the samples a_i <= n < a_{i+1}. These bodies
// assign every sample to its chip against the same float32 boundaries
// (rounded in the plain version's order: the difference, the division,
// then r0 added) and sum each chip's samples directly: the same
// partition, another summation order.

// the unclipped boundary a_i (clipping to [0, lg] changes no comparison
// a_i <= n for a sample 0 <= n < lg)
__device__ __forceinline__ float seg_bound(int i, float r0, float shift,
                                           float step) {
  return ceilf(__fadd_rn(
      r0, __fdiv_rn(__fsub_rn(static_cast<float>(i), shift), step)));
}

// a_i clipped to [0, lg] as the plain version clips it
__device__ __forceinline__ int seg_bound_clip(int i, float r0, float shift,
                                              float step, int lg) {
  const float a = seg_bound(i, r0, shift, step);
  if (!(a > 0.0f)) return 0;
  return a >= static_cast<float>(lg) ? lg : static_cast<int>(a);
}

// The chip c_lo <= i < c_hi that holds sample fn: the largest i with
// a_i <= fn, from the guess floor((fn - r0) step + shift). The caller
// guarantees a_{c_lo} <= fn < a_{c_hi} (clipped), which bounds both walks.
__device__ __forceinline__ int seg_chip(float fn, float r0, float shift,
                                        float step, int c_lo, int c_hi) {
  float gf = floorf(__fadd_rn(__fmul_rn(__fsub_rn(fn, r0), step), shift));
  gf = fminf(fmaxf(gf, static_cast<float>(c_lo)),
             static_cast<float>(c_hi - 1));
  int i = static_cast<int>(gf);
  while (i + 1 < c_hi && seg_bound(i + 1, r0, shift, step) <= fn) ++i;
  while (i > c_lo && seg_bound(i, r0, shift, step) > fn) --i;
  return i;
}

// K1-seg's body for period kk of a K-period group: this thread's partial
// sums of the rotated window samples (window at s0, lg samples, carrier
// rp + ps n) that tap t's chips kk Q .. (kk + 1) Q - 1 hold, each times
// its entry of the table ``code`` (Q entries); period 0 also takes chip
// -1 (folded onto entry Q - 1) and period K - 1 chip K Q (folded onto
// entry 0), the plain version's spill folds. acc[t], acc[NP + t] are tap
// t's re, im; with ND = 1 the prompt tap's chip sums against the data
// code ``dcode`` (read through the read-only cache): acc[2 NP],
// acc[2 NP + 1]. One sincosf a sample serves every tap.
template <typename T, int NP, int ND>
__device__ __forceinline__ void seg_accumulate(
    const T* __restrict__ src_re, const T* __restrict__ src_im, long long s0,
    int lg, int kk, int K, int Q, const float* code,
    const float* __restrict__ dcode, const float (&sh)[NP], float r0,
    float cs, float rp, float ps, float (&acc)[2 * (NP + ND)], int tid,
    int nthreads) {
  constexpr int pt = NP / 2;
#pragma unroll
  for (int i = 0; i < 2 * (NP + ND); ++i) acc[i] = 0.0f;
  const int n_chips = K * Q;
  const int c_lo = kk == 0 ? -1 : kk * Q;
  const int c_hi = kk == K - 1 ? n_chips + 1 : (kk + 1) * Q;
  int lo[NP], hi[NP];
  int n_lo = lg, n_hi = 0;
#pragma unroll
  for (int t = 0; t < NP; ++t) {
    lo[t] = seg_bound_clip(c_lo, r0, sh[t], cs, lg);
    hi[t] = seg_bound_clip(c_hi, r0, sh[t], cs, lg);
    if (hi[t] > lo[t]) {
      n_lo = min(n_lo, lo[t]);
      n_hi = max(n_hi, hi[t]);
    }
  }
  for (int n = n_lo + tid; n < n_hi; n += nthreads) {
    const float fn = static_cast<float>(n);
    float rr, ri;
    derotate(to_f32(src_re[s0 + n]), to_f32(src_im[s0 + n]),
             __fadd_rn(rp, __fmul_rn(ps, fn)), rr, ri);
#pragma unroll
    for (int t = 0; t < NP; ++t) {
      if (n < lo[t] || n >= hi[t]) continue;
      const int i = seg_chip(fn, r0, sh[t], cs, c_lo, c_hi);
      const int q = i < 0 ? Q - 1 : (i >= n_chips ? 0 : i - kk * Q);
      const float c = code[q];
      acc[t] = __fmaf_rn(c, rr, acc[t]);
      acc[NP + t] = __fmaf_rn(c, ri, acc[NP + t]);
      if constexpr (ND == 1) {
        if (t == pt) {
          const float d = __ldg(dcode + q);
          acc[2 * NP] = __fmaf_rn(d, rr, acc[2 * NP]);
          acc[2 * NP + 1] = __fmaf_rn(d, ri, acc[2 * NP + 1]);
        }
      }
    }
  }
}
