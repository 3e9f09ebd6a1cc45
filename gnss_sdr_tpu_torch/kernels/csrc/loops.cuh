// K6's loop steps as device functions: the KF step (K6a) and the
// Gaussian step (K6b) of one channel on registers. loops.cu's kernels run
// them one thread per channel; fast_loop.cu's fused kernel runs them
// inside its group closure. Their rounding is described in loops.cu.
#pragma once
#include "loop_common.cuh"

// The launch parameters, passed by value (ctypes structures of the same
// layout in kernels/loops.py and kernels/fast_loop.py); outside any unnamed
// namespace so that the C launchers taking them keep external linkage.
struct KfParams {
  float f[16];   // F, row-major
  float q[4];    // diag(Q)
  float r[2];    // diag(R)
};

struct GsParams {
  float f[9];    // F, row-major [order x order]
  float q[3];    // diag(Q)
  float t;       // coherent integration time [s]
  int order;     // 2 or 3
  int bayes_run;
  int p_transient;
  int s_transient;
  int bce_kappa;
  int bce_nu;
};

// x_pred = F x and P_pred = (F P) F^T + diag(q), sums in index order
template <int N>
__device__ __forceinline__ void predict(const float* f, const float* q,
                                        const float (&x)[N],
                                        const float (&p)[N][N],
                                        float (&xp)[N], float (&pp)[N][N]) {
  float a[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = mul(f[i * N], x[0]);
#pragma unroll
    for (int j = 1; j < N; ++j) s = fmar(f[i * N + j], x[j], s);
    xp[i] = s;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float v = mul(f[i * N], p[0][k]);
#pragma unroll
      for (int j = 1; j < N; ++j) v = fmar(f[i * N + j], p[j][k], v);
      a[i][k] = v;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int l = 0; l < N; ++l) {
      float v = mul(a[i][0], f[l * N]);
#pragma unroll
      for (int k = 1; k < N; ++k) v = fmar(a[i][k], f[l * N + k], v);
      pp[i][l] = add(v, i == l ? q[i] : 0.0f);
    }
  }
}

// one KF predict + two-measurement update (innovations y0: code [chips],
// y1: phase [rad]); delta = K y
__device__ __forceinline__ void kf_update(const KfParams& prm,
                                          const float (&x)[4],
                                          const float (&p)[4][4], float y0,
                                          float y1, float (&x_out)[4],
                                          float (&p_out)[4][4],
                                          float (&delta)[4]) {
  float xp[4], pp[4][4];
  predict<4>(prm.f, prm.q, x, p, xp, pp);
  // S = P_pred[:2, :2] + R and its closed-form inverse
  const float s00 = add(pp[0][0], prm.r[0]), s01 = add(pp[0][1], 0.0f);
  const float s10 = add(pp[1][0], 0.0f), s11 = add(pp[1][1], prm.r[1]);
  const float det = fmar(s00, s11, -mul(s01, s10));
  const float i00 = __fdiv_rn(s11, det), i01 = __fdiv_rn(-s01, det);
  const float i10 = __fdiv_rn(-s10, det), i11 = __fdiv_rn(s00, det);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float k0 = fmar(pp[i][1], i10, mul(pp[i][0], i00));
    const float k1 = fmar(pp[i][1], i11, mul(pp[i][0], i01));
    const float d = fmar(k1, y1, mul(k0, y0));
    delta[i] = d;
    x_out[i] = add(xp[i], d);
#pragma unroll
    for (int l = 0; l < 4; ++l)
      p_out[i][l] = sub(pp[i][l], fmar(k1, pp[1][l], mul(k0, pp[0][l])));
  }
}

// one Gaussian-loop iteration of order N (2 or 3) with its NIW carry
// (it, n, mu, psi); y the phase discriminator [rad], cn0 [dB-Hz]; info:
// phase correction [rad], Doppler [Hz], Doppler rate [Hz/s], R in use
template <int N>
__device__ __forceinline__ void gaussian_update(
    const GsParams& prm, const float (&x)[N], const float (&p)[N][N], int it,
    int n0, float mu0, float psi0, float y, float cn0, float (&x_out)[N],
    float (&p_out)[N][N], int& it_out, int& n_out, float& mu_out,
    float& psi_out, float (&info)[4]) {
  float xp[N], pp[N][N];
  predict<N>(prm.f, prm.q, x, p, xp, pp);
  xp[0] = x[0];  // the NCO applies the Doppler rotation itself
  // atan phase-detector variance at the current C/N0
  // (gps_l1_ca_gaussian_tracking_cc.cc:675-677); powf is the routine
  // torch.pow runs on the card
  const float cn_lin = powf(10.0f, __fdiv_rn(cn0, 10.0f));
  const float g = __fdiv_rn(1.0f, mul(mul(2.0f, cn_lin), prm.t));
  const float r = mul(g, add(1.0f, g));
  // NIW sequential covariance estimation (bayesian_estimation.cc:88-130)
  const bool do_upd = prm.bayes_run && it >= prm.p_transient;
  const float kappa = static_cast<float>(prm.bce_kappa + n0);
  const float kp1 = add(kappa, 1.0f);
  const float mu_new = __fdiv_rn(add(mul(kappa, mu0), y), kp1);
  const float dy = sub(y, mu0);
  const float psi_new = add(psi0, mul(__fdiv_rn(kappa, kp1), mul(dy, dy)));
  const int n1 = do_upd ? n0 + 1 : n0;
  const float mu1 = do_upd ? mu_new : mu0;
  const float psi1 = do_upd ? psi_new : psi0;
  const float nu_post = static_cast<float>(prm.bce_nu + n1);
  const float nm2 = sub(nu_post, 2.0f);
  const float psi_est = __fdiv_rn(psi1, nm2 > 0.0f ? nm2 : add(nu_post, 2.0f));
  const float hph = pp[0][0];
  const bool use_bayes =
      prm.bayes_run && it >= prm.p_transient + prm.s_transient;
  const float tiny = 1e-12f;
  const float p_y = use_bayes ? fmaxf(psi_est, tiny) : add(hph, r);
  const float r_est = use_bayes ? fmaxf(sub(psi_est, hph), tiny) : r;
  // update with H = [1, 0(, 0)]: K = P_pred[:, 0] / P_y
  float xn[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float k = __fdiv_rn(pp[i][0], p_y);
    xn[i] = add(xp[i], mul(k, y));
#pragma unroll
    for (int l = 0; l < N; ++l) p_out[i][l] = sub(pp[i][l], mul(k, pp[0][l]));
  }
  x_out[0] = 0.0f;  // error-state reset
#pragma unroll
  for (int i = 1; i < N; ++i) x_out[i] = xn[i];
  it_out = it + 1;
  n_out = n1;
  mu_out = mu1;
  psi_out = psi1;
  info[0] = xn[0];
  info[1] = xn[1];
  info[2] = N == 3 ? xn[N - 1] : 0.0f;
  info[3] = r_est;
}
