// K3-loop: the scan engine's whole tracking program, one launch per call.
//
// Replaces gnss_sdr_tpu/tracking/engine.py::TrackingEngine._build_block_step
// .scan_body (:442-741: the K3 correlation, extended accumulation with the
// secondary signs, Costas / four-quadrant PLL with FLL pull-in and wide /
// narrow gains, the E-L or VEMLP DLL IIR with carrier aiding, the int +
// fraction period length and the code / carrier NCO, M2M4 C/N0, the lock
// tests, EVM and the fail counters) under its lax.scan over the PRN
// periods of a block (:748) and over the blocks of a superblock
// (:779-790). Its plain version is the port's per-step path
// (tracking/engine.py::TrackingEngine._blocks_stepwise: K3 + PyTorch).
//
// One block of 256 threads per channel walks n_blocks x n_steps periods:
// all threads correlate the period's window with K3's own body
// (corr_common.cuh: the same thread layout, order and roundings, so the
// correlations equal K3's to the bit), thread 0 runs the loop body on the
// channel's carry in shared memory and writes the period's packed record
// [15 + 2T], and the next period starts after a barrier. After each block
// the offsets are rebased by block_samples. The carry comes in from the
// caller's TrackState tensors and goes out into fresh ones.
//
// Bound: a superblock must read each channel's windows once (2 bytes a
// sample from the int8 ring; 8 from float32 planes), its code table once
// and write its records once: at L1 (8 channels, 10 blocks x 21 steps of
// 4016 samples) ~14 MB, ~4 us at 3.35 TB/s. The real floor is the serial
// chain of periods: each period's NCO depends on the previous period's
// loop closure, so a channel's 210 periods run one after another, each a
// 4016-sample reduction across 256 threads plus ~1-2 us of one thread's
// loop arithmetic. Design: the table in shared memory (opt-in dynamic
// shared memory for E1's 196 KB), the data-component prompt of a
// pilot-tracked channel read from global memory on the same rotated
// samples (the two E1 tables do not fit one block together), the loop
// arithmetic of loop_common.cuh (explicit float32 roundings, PyTorch's
// library routines), no host round trip inside a superblock.
#include "corr_common.cuh"
#include "loop_common.cuh"

constexpr int kMaxCn0 = 64;    // longest prompt buffer (cn0_samples)
constexpr int kMaxExt = 128;   // longest secondary sign table (K)

// Pointers to the TrackState fields, in TrackState's order (ctypes
// structure of the same layout in kernels/scan_loop.py); bool fields are
// one byte. Shapes [C] unless noted.
struct ScanState {
  unsigned char* active;
  int* offset;
  int* cur_len;
  float* rem_code_phase_samples;
  float* rem_code_phase_chips;
  float* rem_carr_phase_rad;
  float* carrier_doppler_hz;
  float* if_freq_hz;
  float* code_doppler_chips;
  float* carrier_phase_step_rad;
  float* code_phase_step_chips;
  float* carr_w;
  float* carr_x;
  float* code_x_hist;          // [C, 4]
  float* code_y_hist;          // [C, 3]
  float* p_old_re;
  float* p_old_im;
  float* prompt_buf_re;        // [C, cn0_samples]
  float* prompt_buf_im;
  int* prompt_count;
  float* cn0_db_hz;
  float* carrier_lock_test;
  float* evm;
  int* code_lock_fail;
  int* carrier_lock_fail;
  unsigned char* loss_of_lock;
  int* step_count;
  unsigned char* extended;
  unsigned char* secondary_locked;
  float* secondary_signs;      // [C, k_ext]
  int* accu_count;
  float* accu_re;              // [C, T]
  float* accu_im;
};

// The engine's shapes and float32 constants as the plain path forms them
// (kernels/scan_loop.py::scan_consts builds the ctypes twin).
struct ScanConsts {
  int n_blocks, n_steps, block_samples, block_stride, total, max_period;
  int code_len, dcode_len, n_extra, n_extra_d;
  int cn0_samples, k_ext, pull_in_steps, t_int, pll_order, veml;
  int carrier_aiding, fll_pull_in, fll_steady, max_code_fail, max_carr_fail;
  float shifts[5];
  float w_w0p, w_w0p2, w_w0p3, w_w0f, w_w0f2;   // wide PLL/FLL gains
  float n_w0p, n_w0p2, n_w0p3, n_w0f, n_w0f2;   // narrow (extended)
  float a2, a3, b3;
  float dll_ic[4], dll_oc[3], dll_ic_n[4], dll_oc_n[3];
  float dll_gain, t_nominal, t_nominal_k, two_pi, inv_two_pi, inv_fs;
  float t_frac_nom, t_nom_over_f0, code_step_nom, aiding, cspc_over_fs;
  float chip_rate, cspc, cn0_a, cn0_1ma, lock_a, lock_1ma;
  float carrier_lock_th, cn0_min, inv_n;
};

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

// one channel's carry, in shared memory (bools as int)
template <int NT>
struct ScanCarry {
  int active, offset, cur_len;
  float rem_code, rem_chips, rem_carr, dopp, if_freq, code_dop;
  float carr_step, code_step, carr_w, carr_x, xh[4], yh[3];
  float p_old_re, p_old_im, pb_re[kMaxCn0], pb_im[kMaxCn0];
  int prompt_count;
  float cn0, lock, evm;
  int code_fail, carr_fail, loss, step_count, extended, sec_locked;
  float signs[kMaxExt];
  int accu_count;
  float accu_re[NT], accu_im[NT];
};

template <int NT>
__device__ void load_carry(const ScanState& in, int c, const ScanConsts& k,
                           ScanCarry<NT>& s) {
  const int n = k.cn0_samples;
  s.active = in.active[c] != 0;
  s.offset = in.offset[c];
  s.cur_len = in.cur_len[c];
  s.rem_code = in.rem_code_phase_samples[c];
  s.rem_chips = in.rem_code_phase_chips[c];
  s.rem_carr = in.rem_carr_phase_rad[c];
  s.dopp = in.carrier_doppler_hz[c];
  s.if_freq = in.if_freq_hz[c];
  s.code_dop = in.code_doppler_chips[c];
  s.carr_step = in.carrier_phase_step_rad[c];
  s.code_step = in.code_phase_step_chips[c];
  s.carr_w = in.carr_w[c];
  s.carr_x = in.carr_x[c];
  for (int i = 0; i < 4; ++i) s.xh[i] = in.code_x_hist[c * 4 + i];
  for (int i = 0; i < 3; ++i) s.yh[i] = in.code_y_hist[c * 3 + i];
  s.p_old_re = in.p_old_re[c];
  s.p_old_im = in.p_old_im[c];
  for (int i = 0; i < n; ++i) {
    s.pb_re[i] = in.prompt_buf_re[c * n + i];
    s.pb_im[i] = in.prompt_buf_im[c * n + i];
  }
  s.prompt_count = in.prompt_count[c];
  s.cn0 = in.cn0_db_hz[c];
  s.lock = in.carrier_lock_test[c];
  s.evm = in.evm[c];
  s.code_fail = in.code_lock_fail[c];
  s.carr_fail = in.carrier_lock_fail[c];
  s.loss = in.loss_of_lock[c] != 0;
  s.step_count = in.step_count[c];
  s.extended = in.extended[c] != 0;
  s.sec_locked = in.secondary_locked[c] != 0;
  for (int i = 0; i < k.k_ext; ++i)
    s.signs[i] = in.secondary_signs[c * k.k_ext + i];
  s.accu_count = in.accu_count[c];
  for (int t = 0; t < NT; ++t) {
    s.accu_re[t] = in.accu_re[c * NT + t];
    s.accu_im[t] = in.accu_im[c * NT + t];
  }
}

template <int NT>
__device__ void store_carry(const ScanState& out, int c, const ScanConsts& k,
                            const ScanCarry<NT>& s) {
  const int n = k.cn0_samples;
  out.active[c] = s.active;
  out.offset[c] = s.offset;
  out.cur_len[c] = s.cur_len;
  out.rem_code_phase_samples[c] = s.rem_code;
  out.rem_code_phase_chips[c] = s.rem_chips;
  out.rem_carr_phase_rad[c] = s.rem_carr;
  out.carrier_doppler_hz[c] = s.dopp;
  out.if_freq_hz[c] = s.if_freq;
  out.code_doppler_chips[c] = s.code_dop;
  out.carrier_phase_step_rad[c] = s.carr_step;
  out.code_phase_step_chips[c] = s.code_step;
  out.carr_w[c] = s.carr_w;
  out.carr_x[c] = s.carr_x;
  for (int i = 0; i < 4; ++i) out.code_x_hist[c * 4 + i] = s.xh[i];
  for (int i = 0; i < 3; ++i) out.code_y_hist[c * 3 + i] = s.yh[i];
  out.p_old_re[c] = s.p_old_re;
  out.p_old_im[c] = s.p_old_im;
  for (int i = 0; i < n; ++i) {
    out.prompt_buf_re[c * n + i] = s.pb_re[i];
    out.prompt_buf_im[c * n + i] = s.pb_im[i];
  }
  out.prompt_count[c] = s.prompt_count;
  out.cn0_db_hz[c] = s.cn0;
  out.carrier_lock_test[c] = s.lock;
  out.evm[c] = s.evm;
  out.code_lock_fail[c] = s.code_fail;
  out.carrier_lock_fail[c] = s.carr_fail;
  out.loss_of_lock[c] = s.loss;
  out.step_count[c] = s.step_count;
  out.extended[c] = s.extended;
  out.secondary_locked[c] = s.sec_locked;
  for (int i = 0; i < k.k_ext; ++i)
    out.secondary_signs[c * k.k_ext + i] = s.signs[i];
  out.accu_count[c] = s.accu_count;
  for (int t = 0; t < NT; ++t) {
    out.accu_re[c * NT + t] = s.accu_re[t];
    out.accu_im[c * NT + t] = s.accu_im[t];
  }
}

// One period's loop body after the correlation (TrackingEngine._step):
// cr/ci the T taps, (dpr, dpi) the data-component prompt; writes the
// packed record [valid, start, length, rem, p_re, p_im, dp_re, dp_im,
// dopp, code_dop, carr_incr, cn0, lock, evm, loss, corr_re(T), corr_im(T)]
// and, for a channel that processes this period, advances its carry (the
// others keep theirs, select(process, new, old)).
template <int NT>
__device__ void scan_period(const ScanConsts& k, ScanCarry<NT>& s,
                            const float* cr, const float* ci, float dpr,
                            float dpi, float* row) {
  constexpr int pt = NT / 2;
  const int n = k.cn0_samples;
  const bool process = s.active && s.offset < k.block_samples && !s.loss;
  row[0] = process ? 1.0f : 0.0f;
  row[1] = static_cast<float>(s.offset);
  row[2] = static_cast<float>(s.cur_len);
  row[3] = s.rem_code;
  row[4] = cr[pt];
  row[5] = ci[pt];
  row[6] = dpr;
  row[7] = dpi;
  for (int t = 0; t < NT; ++t) {
    row[15 + t] = cr[t];
    row[15 + NT + t] = ci[t];
  }
  if (!process) {
    row[8] = s.dopp;
    row[9] = s.code_dop;
    row[10] = 0.0f;
    row[11] = s.cn0;
    row[12] = s.lock;
    row[13] = s.evm;
    row[14] = s.loss ? 1.0f : 0.0f;
    return;
  }

  // ---- extended coherent integration (states 3/4) ----
  const int ai = min(max(s.accu_count, 0), k.k_ext - 1);
  const float sign = s.signs[ai];
  float acc_re[NT], acc_im[NT], eff_re[NT], eff_im[NT];
  const bool ext = s.extended;
  for (int t = 0; t < NT; ++t) {
    acc_re[t] = add(s.accu_re[t], mul(sign, cr[t]));
    acc_im[t] = add(s.accu_im[t], mul(sign, ci[t]));
    eff_re[t] = ext ? acc_re[t] : cr[t];
    eff_im[t] = ext ? acc_im[t] : ci[t];
  }
  int accu_count = s.accu_count + 1;
  const bool run = !ext || accu_count >= k.k_ext;
  const float ep_re = eff_re[pt], ep_im = eff_im[pt];
  const float t_eff = ext ? k.t_nominal_k : k.t_nominal;

  // ---- run_dll_pll ----
  const float pll_rad = s.sec_locked ? atan2f(ep_im, ep_re)
                                     : pll_costas(ep_re, ep_im);
  const float pll_disc = mul(pll_rad, k.inv_two_pi);
  const float fll_disc = mul(
      fll_diff_atan(s.p_old_re, s.p_old_im, ep_re, ep_im, t_eff),
      k.inv_two_pi);
  const bool pull_in = s.step_count < k.pull_in_steps;
  float fll_eff = 0.0f, pll_eff = pll_disc;
  if (k.fll_pull_in || k.fll_steady) {
    const bool use_fll = (pull_in && k.fll_pull_in) || k.fll_steady;
    fll_eff = use_fll ? fll_disc : 0.0f;
    pll_eff = (pull_in && k.fll_pull_in) ? 0.0f : pll_disc;
  }
  FllPllGainsF g;
  const float w0p = ext ? k.n_w0p : k.w_w0p;
  g.w0p2 = ext ? k.n_w0p2 : k.w_w0p2;
  g.w0p3 = ext ? k.n_w0p3 : k.w_w0p3;
  g.w0f = ext ? k.n_w0f : k.w_w0f;
  g.w0f2 = ext ? k.n_w0f2 : k.w_w0f2;
  g.a2w0f = mul(k.a2, g.w0f);
  g.a3w0p2 = mul(k.a3, g.w0p2);
  g.b3w0p = mul(k.b3, w0p);
  g.a2w0p = mul(k.a2, w0p);
  float w = s.carr_w, x = s.carr_x;
  const float err = fll_pll_step(k.pll_order, g, fll_eff, pll_eff, t_eff, w,
                                 x);
  const float dopp = run ? err : s.dopp;

  float dll;   // VEMLP with the five VEML taps, else E-L
  if constexpr (NT == 5)
    dll = dll_vemlp(eff_re, eff_im);
  else
    dll = dll_e_minus_l(eff_re[0], eff_im[0], eff_re[2], eff_im[2],
                        k.dll_gain);
  float xh[4], yh[3];
  for (int i = 0; i < 4; ++i) xh[i] = s.xh[i];
  for (int i = 0; i < 3; ++i) yh[i] = s.yh[i];
  const float code_err = iir_step(xh, yh, dll, ext ? k.dll_ic_n : k.dll_ic,
                                  ext ? k.dll_oc_n : k.dll_oc);
  float code_dop_new = -code_err;
  if (k.carrier_aiding) code_dop_new = add(code_dop_new, mul(dopp, k.aiding));
  const float code_dop = run ? code_dop_new : s.code_dop;
  if (run && ext) {
    for (int t = 0; t < NT; ++t) acc_re[t] = acc_im[t] = 0.0f;
  }
  if (run) accu_count = 0;

  // ---- update_tracking_vars: int + small fraction ----
  const float t_frac = sub(k.t_frac_nom, mul(code_dop, k.t_nom_over_f0));
  const float kfrac = add(t_frac, s.rem_code);
  const float dlen = floorf(kfrac);
  const int next_len = k.t_int + static_cast<int>(dlen);
  const float rem_code = sub(kfrac, dlen);
  const float carr_step = mul(mul(k.two_pi, add(dopp, s.if_freq)), k.inv_fs);
  const float nlf = static_cast<float>(next_len);
  const float carr_incr = mul(carr_step, nlf);
  const float carr_incr_out = mul(mul(mul(k.two_pi, dopp), k.inv_fs), nlf);
  const float rem_carr = remainder_f(add(s.rem_carr, carr_incr), k.two_pi);
  const float code_step = add(k.code_step_nom, mul(code_dop, k.cspc_over_fs));
  const float rem_chips = mul(mul(mul(add(k.chip_rate, code_dop), rem_code),
                                  k.inv_fs), k.cspc);

  // ---- cn0_and_tracking_lock_status ----
  if (run) {
    for (int i = n - 1; i > 0; --i) {
      s.pb_re[i] = s.pb_re[i - 1];
      s.pb_im[i] = s.pb_im[i - 1];
    }
    s.pb_re[0] = ep_re;
    s.pb_im[0] = ep_im;
  }
  const int count_pre = s.prompt_count;
  const bool have = count_pre >= n, first = count_pre == n;
  const bool upd = have && run;
  const float cn0_raw = cn0_m2m4(s.pb_re, s.pb_im, n, k.inv_n, t_eff);
  const float cn0 = upd ? (first ? cn0_raw
                                 : add(mul(k.cn0_a, cn0_raw),
                                       mul(k.cn0_1ma, s.cn0)))
                        : s.cn0;
  const float lock_raw = carrier_lock(ep_re, ep_im);
  const float lock = upd ? (first ? lock_raw
                                  : add(mul(k.lock_a, lock_raw),
                                        mul(k.lock_1ma, s.lock)))
                         : s.lock;
  const bool count_locks = have && !pull_in && run;
  const int cl = count_locks ? 1 : 0;
  int carr_fail = (count_locks && lock < k.carrier_lock_th)
                      ? s.carr_fail + 1 : max(s.carr_fail - cl, 0);
  int code_fail = (count_locks && cn0 < k.cn0_min)
                      ? s.code_fail + 1 : max(s.code_fail - cl, 0);
  const bool loss = carr_fail > k.max_carr_fail || code_fail > k.max_code_fail;
  if (loss) carr_fail = code_fail = 0;
  const float evm = have ? evm_of(s.pb_re, s.pb_im, n, k.inv_n) : s.evm;

  // ---- the new carry; the stream advances with the new length ----
  row[8] = dopp;
  row[9] = code_dop;
  row[10] = carr_incr_out;
  row[11] = cn0;
  row[12] = lock;
  row[13] = evm;
  s.offset += next_len;
  s.cur_len = next_len;
  s.rem_code = rem_code;
  s.rem_chips = rem_chips;
  s.rem_carr = rem_carr;
  s.dopp = dopp;
  s.code_dop = code_dop;
  s.carr_step = carr_step;
  s.code_step = code_step;
  if (run) {
    s.carr_w = w;
    s.carr_x = x;
    for (int i = 0; i < 4; ++i) s.xh[i] = xh[i];
    for (int i = 0; i < 3; ++i) s.yh[i] = yh[i];
    s.p_old_re = ep_re;
    s.p_old_im = ep_im;
  }
  s.prompt_count = min(count_pre + (run ? 1 : 0), n + 1);
  s.cn0 = cn0;
  s.lock = lock;
  s.evm = evm;
  s.code_fail = code_fail;
  s.carr_fail = carr_fail;
  s.loss = s.loss || (loss && s.active);
  s.step_count += 1;
  s.accu_count = accu_count;
  for (int t = 0; t < NT; ++t) {
    s.accu_re[t] = acc_re[t];
    s.accu_im[t] = acc_im[t];
  }
  row[14] = s.loss ? 1.0f : 0.0f;
}

// ND = 1: the data-component prompt of a pilot-tracked channel
template <typename T, int NT, int ND>
__global__ void __launch_bounds__(kThreads)
scan_loop_kernel(const T* __restrict__ src_re, const T* __restrict__ src_im,
                 long long base, const float* __restrict__ code,
                 const float* __restrict__ dcode, ScanState in,
                 ScanState out, ScanConsts k, float* __restrict__ packed) {
  extern __shared__ float s_code[];
  __shared__ float scratch[2 * (NT + ND) * 32];
  __shared__ ScanCarry<NT> st;
  const int c = blockIdx.x, C = gridDim.x;
  for (int i = threadIdx.x; i < k.code_len; i += blockDim.x)
    s_code[i] = code[(size_t)c * k.code_len + i];
  if (threadIdx.x == 0) load_carry<NT>(in, c, k, st);
  __syncthreads();
  float sh[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) sh[t] = k.shifts[t];
  const float* dc = ND ? dcode + (size_t)c * k.dcode_len : nullptr;
  constexpr int kW = 15 + 2 * NT;
  for (int b = 0; b < k.n_blocks; ++b) {
    const long long bb = base + (long long)b * k.block_stride;
    for (int step = 0; step < k.n_steps; ++step) {
      // TrackingEngine.window_start: the window stays inside the block
      const int start = min(max(st.offset, 0), k.total - k.max_period);
      float acc[2 * (NT + ND)];
      k3_accumulate<T, NT, ND>(
          src_re, src_im, bb + start, min(st.cur_len, k.max_period), s_code,
          k.code_len, sh, k.n_extra, dc, k.dcode_len, k.n_extra_d,
          st.rem_chips, st.code_step, st.rem_carr, st.carr_step, acc,
          threadIdx.x, blockDim.x);
      block_sum<2 * (NT + ND)>(acc, scratch);
      if (threadIdx.x == 0) {
        float* row = packed + (((size_t)b * k.n_steps + step) * C + c) * kW;
        // the decoder's prompt: the data component's, else the pilot's own
        float dpr = acc[NT / 2], dpi = acc[NT + NT / 2];
        if constexpr (ND == 1) {
          dpr = acc[2 * NT];
          dpi = acc[2 * NT + 1];
        }
        scan_period<NT>(k, st, acc, acc + NT, dpr, dpi, row);
      }
      __syncthreads();
    }
    if (threadIdx.x == 0 && st.active) st.offset -= k.block_samples;
    __syncthreads();
  }
  if (threadIdx.x == 0) store_carry<NT>(out, c, k, st);
}

template <typename T, int NT, int ND>
int launch_one(const T* re, const T* im, long long base, const float* code,
               const float* dcode, const ScanState& in, const ScanState& out,
               const ScanConsts& k, float* packed, int C,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * k.code_len;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_loop_kernel<T, NT, ND>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  scan_loop_kernel<T, NT, ND><<<C, kThreads, smem, stream>>>(
      re, im, base, code, dcode, in, out, k, packed);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* re, const T* im, long long base, const float* code,
           const float* dcode, int n_taps, int track_pilot, ScanState in,
           ScanState out, ScanConsts k, float* packed, int C,
           cudaStream_t stream) {
  if (k.cn0_samples < 1 || k.cn0_samples > kMaxCn0 || k.k_ext < 1 ||
      k.k_ext > kMaxExt || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int key = n_taps * 2 + (track_pilot ? 1 : 0);
#define K3L_CASE(NT, ND)                                                   \
  case NT * 2 + ND:                                                        \
    return launch_one<T, NT, ND>(re, im, base, code, dcode, in, out, k,    \
                                 packed, C, stream);
  switch (key) {
    K3L_CASE(3, 0)
    K3L_CASE(3, 1)
    K3L_CASE(5, 0)
    K3L_CASE(5, 1)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K3L_CASE
}

}  // namespace

extern "C" {

// int8 planar ring (superblock_ring_i8); the widening folded into the load
int scan_loop_i8(const int8_t* re, const int8_t* im, long long base,
                 const float* code, const float* dcode, int n_taps,
                 int track_pilot, ScanState in, ScanState out, ScanConsts k,
                 float* packed, int C, void* stream) {
  return launch<int8_t>(re, im, base, code, dcode, n_taps, track_pilot, in,
                        out, k, packed, C, static_cast<cudaStream_t>(stream));
}

// float32 planes (process_block, superblock_step)
int scan_loop_f32(const float* re, const float* im, long long base,
                  const float* code, const float* dcode, int n_taps,
                  int track_pilot, ScanState in, ScanState out, ScanConsts k,
                  float* packed, int C, void* stream) {
  return launch<float>(re, im, base, code, dcode, n_taps, track_pilot, in,
                       out, k, packed, C, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
