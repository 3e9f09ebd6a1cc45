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
#include "loops.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
kf_step_kernel(const float* __restrict__ x_in, const float* __restrict__ p_in,
               const float* __restrict__ code_err,
               const float* __restrict__ phase_err, int C, KfParams prm,
               float* __restrict__ x_out, float* __restrict__ p_out,
               float* __restrict__ delta_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float x[4], p[4][4], xo[4], po[4][4], d[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = x_in[c * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) p[i][j] = p_in[c * 16 + i * 4 + j];
  }
  kf_update(prm, x, p, code_err[c], phase_err[c], xo, po, d);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    delta_out[c * 4 + i] = d[i];
    x_out[c * 4 + i] = xo[i];
#pragma unroll
    for (int l = 0; l < 4; ++l) p_out[c * 16 + i * 4 + l] = po[i][l];
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
  float x[N], p[N][N], xo[N], po[N][N], inf[4];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] = x_in[c * N + i];
#pragma unroll
    for (int j = 0; j < N; ++j) p[i][j] = p_in[c * N * N + i * N + j];
  }
  gaussian_update<N>(prm, x, p, it_in[c], n_in[c], mu_in[c], psi_in[c],
                     phase_err[c], cn0[c], xo, po, it_out[c], n_out[c],
                     mu_out[c], psi_out[c], inf);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x_out[c * N + i] = xo[i];
#pragma unroll
    for (int l = 0; l < N; ++l) p_out[c * N * N + i * N + l] = po[i][l];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) info[i * C + c] = inf[i];
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
