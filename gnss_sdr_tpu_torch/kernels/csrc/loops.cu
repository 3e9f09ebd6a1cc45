// K6: the fast engine's KF and Gaussian loop steps, one thread per channel.
//
// Replaces gnss_sdr_tpu/ops/kalman.py::kf_step (K6a) and
// gnss_sdr_tpu/ops/gaussian.py::gaussian_step (K6b), which run inside the
// fast engine's loop closure once per K-period group
// (tracking/fast_engine.py:469-536).
//
//   (a) kf_step: the 4-state code/carrier KF: x_pred = F x,
//       P_pred = (F P) F^T + Q, then the two-measurement update with the
//       closed-form 2x2 inverse of S = H P_pred H^T + R, the gain
//       K = P_pred H^T S^-1, delta = K y, P = P_pred - (K H) P_pred.
//   (b) gaussian_step: the order-2/3 carrier KF (phase error held through
//       the predict), the normal-inverse-Wishart posterior of the phase
//       measurement after p_transient iterations, its variance in use after
//       p_transient + s_transient, the scalar-measurement gain, the
//       error-state reset and the info outputs (phase correction, Doppler,
//       Doppler rate, R in use).
//
// Bound: a channel's whole state is a few hundred bytes and a few hundred
// flops, so at the path's C = 8 a launch is latency-bound; at C = 4096 it
// is bound by bytes (each thread reads and writes its state once). Design:
// the matrices live in registers (fully unrolled, no local memory), F, Q
// and R come by value in the launch parameters (no host copy, no sync),
// and every product and sum is rounded where the plain version rounds it:
// a matrix or vector product is the first term's product followed by one
// fused multiply-add per further term, over j, then over k, first index
// first, which is how the JAX package's einsums run on the CPU (its 2- and
// 3-term dots to the bit); everything else is explicitly rounded (no
// contraction). The plain version repeats that order, so the two agree to
// the bit and the covariance keeps the symmetry the JAX einsums give it.
#include "common.cuh"

// The launch parameters, passed by value (ctypes structures of the same
// layout in kernels/loops.py); outside the unnamed namespace so that the
// C launchers taking them keep external linkage.
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

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmar(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

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

__global__ void __launch_bounds__(kThreads)
kf_step_kernel(const float* __restrict__ x_in, const float* __restrict__ p_in,
               const float* __restrict__ code_err,
               const float* __restrict__ phase_err, int C, KfParams prm,
               float* __restrict__ x_out, float* __restrict__ p_out,
               float* __restrict__ delta_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float x[4], p[4][4], xp[4], pp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = x_in[c * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) p[i][j] = p_in[c * 16 + i * 4 + j];
  }
  predict<4>(prm.f, prm.q, x, p, xp, pp);
  const float y0 = code_err[c], y1 = phase_err[c];
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
    delta_out[c * 4 + i] = d;
    x_out[c * 4 + i] = add(xp[i], d);
#pragma unroll
    for (int l = 0; l < 4; ++l)
      p_out[c * 16 + i * 4 + l] =
          sub(pp[i][l], fmar(k1, pp[1][l], mul(k0, pp[0][l])));
  }
}

template <int N>
__device__ void gaussian_channel(
    int c, const float* __restrict__ x_in, const float* __restrict__ p_in,
    const int* __restrict__ it_in, const int* __restrict__ n_in,
    const float* __restrict__ mu_in, const float* __restrict__ psi_in,
    const float* __restrict__ phase_err, const float* __restrict__ cn0,
    int C, const GsParams& prm, float* __restrict__ x_out,
    float* __restrict__ p_out, int* __restrict__ it_out,
    int* __restrict__ n_out, float* __restrict__ mu_out,
    float* __restrict__ psi_out, float* __restrict__ info) {
  float x[N], p[N][N], xp[N], pp[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] = x_in[c * N + i];
#pragma unroll
    for (int j = 0; j < N; ++j) p[i][j] = p_in[c * N * N + i * N + j];
  }
  predict<N>(prm.f, prm.q, x, p, xp, pp);
  xp[0] = x[0];  // the NCO applies the Doppler rotation itself
  const float y = phase_err[c];
  // atan phase-detector variance at the current C/N0
  // (gps_l1_ca_gaussian_tracking_cc.cc:675-677); powf is the routine
  // torch.pow runs on the card
  const float cn_lin = powf(10.0f, __fdiv_rn(cn0[c], 10.0f));
  const float g = __fdiv_rn(1.0f, mul(mul(2.0f, cn_lin), prm.t));
  const float r = mul(g, add(1.0f, g));
  // NIW sequential covariance estimation (bayesian_estimation.cc:88-130)
  const int it = it_in[c];
  const int n0 = n_in[c];
  const float mu0 = mu_in[c], psi0 = psi_in[c];
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
    for (int l = 0; l < N; ++l)
      p_out[c * N * N + i * N + l] = sub(pp[i][l], mul(k, pp[0][l]));
  }
  x_out[c * N] = 0.0f;  // error-state reset
#pragma unroll
  for (int i = 1; i < N; ++i) x_out[c * N + i] = xn[i];
  it_out[c] = it + 1;
  n_out[c] = n1;
  mu_out[c] = mu1;
  psi_out[c] = psi1;
  info[c] = xn[0];                          // phase correction [rad]
  info[C + c] = xn[1];                      // carrier Doppler [Hz]
  info[2 * C + c] = N == 3 ? xn[N - 1] : 0.0f;  // Doppler rate [Hz/s]
  info[3 * C + c] = r_est;
}

__global__ void __launch_bounds__(kThreads)
gaussian_step_kernel(const float* __restrict__ x_in,
                     const float* __restrict__ p_in,
                     const int* __restrict__ it_in,
                     const int* __restrict__ n_in,
                     const float* __restrict__ mu_in,
                     const float* __restrict__ psi_in,
                     const float* __restrict__ phase_err,
                     const float* __restrict__ cn0, int C, GsParams prm,
                     float* __restrict__ x_out, float* __restrict__ p_out,
                     int* __restrict__ it_out, int* __restrict__ n_out,
                     float* __restrict__ mu_out, float* __restrict__ psi_out,
                     float* __restrict__ info) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  if (prm.order == 3)
    gaussian_channel<3>(c, x_in, p_in, it_in, n_in, mu_in, psi_in,
                        phase_err, cn0, C, prm, x_out, p_out, it_out, n_out,
                        mu_out, psi_out, info);
  else
    gaussian_channel<2>(c, x_in, p_in, it_in, n_in, mu_in, psi_in,
                        phase_err, cn0, C, prm, x_out, p_out, it_out, n_out,
                        mu_out, psi_out, info);
}

inline unsigned blocks_for(int n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int kf_step(const float* x, const float* p, const float* code_err,
            const float* phase_err, int C, KfParams prm, float* x_out,
            float* p_out, float* delta, void* stream) {
  kf_step_kernel<<<blocks_for(C), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      x, p, code_err, phase_err, C, prm, x_out, p_out, delta);
  return static_cast<int>(cudaGetLastError());
}

int gaussian_step(const float* x, const float* p, const int* it,
                  const int* n, const float* mu, const float* psi,
                  const float* phase_err, const float* cn0, int C,
                  GsParams prm, float* x_out, float* p_out, int* it_out,
                  int* n_out, float* mu_out, float* psi_out, float* info,
                  void* stream) {
  if (prm.order != 2 && prm.order != 3) return cudaErrorInvalidValue;
  gaussian_step_kernel<<<blocks_for(C), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, p, it, n, mu, psi, phase_err, cn0, C, prm, x_out, p_out, it_out,
      n_out, mu_out, psi_out, info);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
