// The tracking loops' arithmetic as device functions (scan_loop.cu,
// fast_loop.cu, loops.cuh).
//
// Each function repeats one function of the port's plain PyTorch ops
// (ops/discriminators.py, ops/loop_filters.py, ops/lock_detectors.py, the
// scan engine's EVM) as those run on the card: every elementwise torch op
// is one float32 rounding, written as one __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn (no contraction into fused multiply-adds), and
// the library routines are the ones PyTorch's CUDA ops call (atan2f,
// atanf, sqrtf, log10f, floorf, fmodf). Two rules of PyTorch's CUDA
// kernels are kept:
//   - a tensor divided by a Python number is multiplied by the number's
//     float32 reciprocal (div_true_kernel_cuda with a CPU scalar): the
//     callers pass such reciprocals (1 / 2 pi, 1 / fs) precomputed;
//   - a mean over n entries is their sum times the float32 factor 1 / n
//     (MeanOps). The plain reductions sum in an order of their own, so
//     sums of 3 to 20 terms here (in index order) may differ from them by
//     an ulp; that is the only expected disagreement.
#pragma once

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sq(float a) { return __fmul_rn(a, a); }
__device__ __forceinline__ float fmar(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// torch.remainder(a, b) for float32 on the card: fmod, then b added when
// the signs of the result and b differ
__device__ __forceinline__ float remainder_f(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m = add(m, b);
  return m;
}

// ---- ops/discriminators.py ------------------------------------------------

// Costas atan(Q/I), 0 when I == 0
__device__ __forceinline__ float pll_costas(float re, float im) {
  return atanf(re != 0.0f ? dvd(im, re) : 0.0f);
}

// phase_unwrap: fold into (-pi/2, pi/2]
__device__ __forceinline__ float phase_unwrap(float x) {
  const float half_pi = 1.57079637f;       // float32(pi / 2)
  const float pi = 3.14159274f;            // float32(pi)
  x = x >= half_pi ? sub(x, pi) : x;
  return x <= -half_pi ? add(x, pi) : x;
}

// fll_diff_atan with t1 = 0: [rad/s]; a NaN difference counts as 0
__device__ __forceinline__ float fll_diff_atan(float p1_re, float p1_im,
                                               float p2_re, float p2_im,
                                               float t2) {
  float diff = sub(atanf(dvd(p2_im, p2_re)), atanf(dvd(p1_im, p1_re)));
  if (isnan(diff)) diff = 0.0f;
  return dvd(phase_unwrap(diff), t2);
}

// dll_nc_e_minus_l_normalized with its gain ((y0 - slope spc) / slope)
// computed on the host in double and rounded to float32
__device__ __forceinline__ float dll_e_minus_l(float e_re, float e_im,
                                               float l_re, float l_im,
                                               float gain) {
  const float e = sqrtf(add(sq(e_re), sq(e_im)));
  const float l = sqrtf(add(sq(l_re), sq(l_im)));
  const float s = add(e, l);
  return mul(gain, s > 0.0f ? dvd(sub(e, l), s) : 0.0f);
}

// dll_nc_vemlp_normalized over taps VE, E, L, VL (re[0], re[1], re[3],
// re[4] of a 5-tap correlation)
__device__ __forceinline__ float dll_vemlp(const float* re, const float* im) {
  const float e = sqrtf(add(add(add(sq(re[0]), sq(im[0])), sq(re[1])),
                            sq(im[1])));
  const float l = sqrtf(add(add(add(sq(re[3]), sq(im[3])), sq(re[4])),
                            sq(im[4])));
  const float s = add(e, l);
  return s > 0.0f ? dvd(sub(e, l), s) : 0.0f;
}

// ---- ops/loop_filters.py --------------------------------------------------

// fll_pll_step's gains as its caller forms them: w0p, w0p2, w0p3, w0f,
// w0f2 and the products a2 w0f, a3 w0p2, b3 w0p, a2 w0p, each one float32
struct FllPllGainsF {
  float w0p2, w0p3, w0f, w0f2, a2w0f, a3w0p2, b3w0p, a2w0p;
};

// get_carrier_error of order 2 or 3: (w, x) updated, returns the carrier
// error [Hz]
__device__ __forceinline__ float fll_pll_step(int order,
                                              const FllPllGainsF& g,
                                              float fll, float pll, float t,
                                              float& w, float& x) {
  if (order == 3) {
    const float w_new = add(w, mul(t, add(mul(g.w0p3, pll), mul(g.w0f2, fll))));
    const float x_new = add(x, mul(t, add(add(mul(0.5f, w_new),
                                              mul(g.a2w0f, fll)),
                                          mul(g.a3w0p2, pll))));
    w = w_new;
    x = x_new;
    return add(mul(0.5f, x_new), mul(g.b3w0p, pll));
  }
  const float w_new = add(add(w, mul(mul(pll, g.w0p2), t)),
                          mul(mul(fll, g.w0f), t));
  const float err = add(mul(0.5f, add(w_new, w)), mul(g.a2w0p, pll));
  w = w_new;
  return err;
}

// Tracking_loop_filter::apply: x_hist[4], y_hist[3] newest first;
// returns the filter output
__device__ __forceinline__ float iir_step(float* xh, float* yh, float x,
                                          const float* ic, const float* oc) {
  float r = mul(oc[0], yh[0]);
  r = add(r, mul(oc[1], yh[1]));
  r = add(r, mul(oc[2], yh[2]));
  xh[3] = xh[2];
  xh[2] = xh[1];
  xh[1] = xh[0];
  xh[0] = x;
  float s = mul(ic[0], xh[0]);
#pragma unroll
  for (int i = 1; i < 4; ++i) s = add(s, mul(ic[i], xh[i]));
  r = add(r, s);
  yh[2] = yh[1];
  yh[1] = yh[0];
  yh[0] = r;
  return r;
}

// ---- ops/lock_detectors.py ------------------------------------------------

constexpr float kTiny = 1.17549435e-38f;   // float32 tiny

// cn0_m2m4_estimator over the n prompts of pb_re/pb_im at coherent time
// t [dB-Hz]; inv_n = float32(1 / n)
__device__ __forceinline__ float cn0_m2m4(const float* pb_re,
                                          const float* pb_im, int n,
                                          float inv_n, float t) {
  float sa = 0.0f, s2 = 0.0f, s4 = 0.0f;
  for (int i = 0; i < n; ++i) {
    const float aux = add(sq(pb_re[i]), sq(pb_im[i]));
    sa = add(sa, fabsf(pb_re[i]));
    s2 = add(s2, aux);
    s4 = add(s4, sq(aux));
  }
  const float psig = sq(mul(sa, inv_n));
  const float m2 = mul(s2, inv_n);
  const float m4 = mul(s4, inv_n);
  const float arg = sub(mul(mul(2.0f, m2), m2), m4);
  const float num = arg >= 0.0f ? sqrtf(arg) : psig;
  const float snr = dvd(num, clamp_min(sub(m2, num), kTiny));
  return sub(mul(10.0f, log10f(clamp_min(snr, kTiny))),
             mul(10.0f, log10f(t)));
}

// carrier_lock_detector of one prompt
__device__ __forceinline__ float carrier_lock(float re, float im) {
  const float nbp = add(sq(re), sq(im));
  const float nbd = sub(sq(re), sq(im));
  return dvd(nbd, clamp_min(nbp, kTiny));
}

// the fork's EVM indicator over the n prompts (scan engine)
__device__ __forceinline__ float evm_of(const float* pb_re,
                                        const float* pb_im, int n,
                                        float inv_n) {
  float s = 0.0f;
  for (int i = 0; i < n; ++i) s = add(s, sq(pb_re[i]));
  const float d = clamp_min(sqrtf(mul(s, inv_n)), kTiny);
  float v = 0.0f;
  for (int i = 0; i < n; ++i)
    v = add(v, add(sq(sub(fabsf(dvd(pb_re[i], d)), 1.0f)),
                   sq(dvd(pb_im[i], d))));
  return sqrtf(mul(v, inv_n));
}
