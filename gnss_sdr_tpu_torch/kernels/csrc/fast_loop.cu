// K1-loop: the fast engine's whole tracking program, one launch per call.
//
// Replaces gnss_sdr_tpu/tracking/fast_engine.py::FastTrackingEngine._build
// .group_body + close_loops (:422-745: the group prologue with the closed
// form period boundaries offset + k t_int + floor(rem + k t_frac), window
// starts, bank row and weight; the K1 bank correlation with the data tap;
// the secondary wipe-off; the group sum; the Costas / four-quadrant PLL,
// the E-L or VEMLP DLL and the FLL/PLL filter with the DLL IIR, or the KF
// (K6a) or Gaussian (K6b) closure with their phase corrections; the carry;
// M2M4 C/N0, the lock tests and the packed record [5K + 4]) under its
// lax.scan over the groups of a block (:839) and the blocks of a
// superblock (:867-878). Its plain version is the port's per-group path
// (tracking/fast_engine.py::FastTrackingEngine._blocks_stepwise: K1, K6
// and PyTorch).
//
// Design: one thread-block cluster of S blocks per channel walks
// n_blocks x G groups. Per group the leader's threads compute the K
// periods' boundaries, window starts, carrier phases and bank rows (one
// period a thread); after a cluster barrier the periods, independent
// once their NCO is fixed, are correlated by the cluster's blocks, period
// j by block j mod S, each whole on one block with K1's own body
// (corr_common.cuh: K1 runs one block per period with the same thread
// layout, order and roundings, so the correlations equal K1's to the
// bit) and its interpolated sums written into the leader's shared memory
// (distributed shared memory); after a second barrier thread 0 of the
// leader closes the loops on the channel's carry (the KF and Gaussian
// steps through loops.cuh, K6's own device functions) and writes the
// group's record. A group's periods cannot start before the previous
// group's closure; one block a channel would walk them one after
// another (25 x ~41 us a group at E1, on 8 of 132 SMs at C = 8). S (fast_cluster) takes the fewest rounds of at
// most 16 blocks: 10 blocks of two periods at L1 (K = 20), 13 at E1
// (K = 25). The cluster's barriers stand in for the grid-wide barrier a
// launch of C K blocks would need twice a group.
//
// Bound: a superblock must read each channel's windows once (2 bytes a
// sample from the int8 ring), the bank rows it uses once and write its
// records once: at L1 (8 channels, 10 blocks x 5 groups x 20 periods of
// 4001 samples, 2 rows of 3 taps a period) ~17 MB, ~5 us at 3.35 TB/s;
// the real floor is the serial chain of groups of each channel: per
// group one period's correlation on one block, two cluster barriers and
// one thread's closure.
//
// K1-seg (fast_loop_seg_kernel, a segsum engine): the correlation body is
// the segmented sum of gnss_sdr_tpu/tracking/fast_engine.py:746-828 (the
// group window of lg = K T + 64 samples from clip(offset, 0, total - lg),
// rotated once; each tap's chips at the float32 boundaries ceil(r0 + (c -
// shift) / code_step); the spill bins c = -1 and c = K Q folded onto the
// first and last period's wrap entries; the raw code table; the data
// prompt from the prompt tap's chips). Per period the block walks the
// samples the taps' chips of that period hold (corr_common.cuh::
// seg_accumulate), locating each sample's chip against those boundaries,
// and sums them directly: at E1, 25 x 49104 bins a tap of which most hold
// no sample, a walk over the samples reads each once. The plain version
// differences float32 prefix sums, so the two agree to the rounding of
// those sums, not to the bit. Its periods spread over the cluster as
// K1's do, each summed whole by one block, so the cluster changes none
// of its bits. The pilot table stays in shared memory of every block
// (196 KB at E1, opted in above 48 KB; one block an SM, so clusters of
// at most 8), the data table is read from L2.
// Bound: the windows once (64 MB at L1 and at E1 a superblock, ~19 us).
#include "corr_common.cuh"
#include "loops.cuh"

constexpr int kMaxCn0 = 64;    // longest prompt buffer (cn0_samples)
constexpr int kMaxK = 128;     // longest group (K periods)
constexpr int kMaxSec = 128;   // longest secondary code (sec_max_len)

// Pointers to the FastState fields, in FastState's order (ctypes structure
// of the same layout in kernels/fast_loop.py); bool fields are one byte.
// Shapes [C] unless noted.
struct FastStatePtrs {
  unsigned char* active;
  int* offset;
  float* rem_code_phase_samples;
  float* rem_carr_phase_rad;
  float* carrier_doppler_hz;
  float* if_freq_hz;
  float* code_doppler_chips;
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
  int* code_lock_fail;
  int* carrier_lock_fail;
  unsigned char* loss_of_lock;
  float* kf_x;                 // [C, 4]
  float* kf_p;                 // [C, 4, 4]
  float* gs_niw;               // [C, 4]
  float* sec_signs;            // [C, sec_max_len]
  int* sec_len;
  int* sec_phase;
  unsigned char* secondary_locked;
};

// The engine's shapes and float32 constants as the plain path forms them
// (kernels/fast_loop.py::fast_consts builds the ctypes twin).
struct FastConsts {
  int n_blocks, n_groups, K, block_samples, block_stride, total, win_len;
  int n_eff, P1, W, cn0_samples, sec_max_len, t_int, k_t_int;
  int loop, pll_order, veml, carrier_aiding, max_code_fail, max_carr_fail;
  int seg, lg, table_len;        // segmented sum: flag, window, table
  float t_frac_nom, t_nom_over_f0, half_t_over_f0, two_pi, inv_two_pi;
  float inv_fs, t_group, k_f32, k_t_int_f32, fs_over_chip, aiding;
  float dll_gain, cn0_a, cn0_1ma, lock_a, lock_1ma, carrier_lock_th;
  float cn0_min, inv_n, bank_phases, code_step_nom, cspc_over_fs;
  float dll_ic[4], dll_oc[3];
  float shifts[5];               // tap shifts [table entries] (segsum)
  FllPllGainsF g;
  KfParams kf;
  GsParams gs;
};

namespace {

constexpr int kThreads = 256;
constexpr int kLoopKf = 1, kLoopGaussian = 2;

struct FastCarry {
  int active, offset;
  float rem, rem_carr, dopp, if_freq, code_dop, carr_w, carr_x;
  float xh[4], yh[3], p_old_re, p_old_im, pb_re[kMaxCn0], pb_im[kMaxCn0];
  int prompt_count;
  float cn0, lock;
  int code_fail, carr_fail, loss;
  float kf_x[4], kf_p[16], gs_niw[4], sec_signs[kMaxSec];
  int sec_len, sec_phase, sec_locked;
};

// the inputs of the group's K periods (group_inputs), in shared memory;
// the segmented sum's group window and NCO (segsum_corr) beside them
struct GroupInputs {
  int start[kMaxK], win[kMaxK], j0[kMaxK];
  float rem[kMaxK], ph0[kMaxK], w[kMaxK];
  float step;
  int seg_win;
  float seg_code_step, seg_rem, seg_rem_carr;
};

__device__ void load_carry(const FastStatePtrs& in, int c,
                           const FastConsts& k, FastCarry& s) {
  const int n = k.cn0_samples;
  s.active = in.active[c] != 0;
  s.offset = in.offset[c];
  s.rem = in.rem_code_phase_samples[c];
  s.rem_carr = in.rem_carr_phase_rad[c];
  s.dopp = in.carrier_doppler_hz[c];
  s.if_freq = in.if_freq_hz[c];
  s.code_dop = in.code_doppler_chips[c];
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
  s.code_fail = in.code_lock_fail[c];
  s.carr_fail = in.carrier_lock_fail[c];
  s.loss = in.loss_of_lock[c] != 0;
  for (int i = 0; i < 4; ++i) s.kf_x[i] = in.kf_x[c * 4 + i];
  for (int i = 0; i < 16; ++i) s.kf_p[i] = in.kf_p[c * 16 + i];
  for (int i = 0; i < 4; ++i) s.gs_niw[i] = in.gs_niw[c * 4 + i];
  for (int i = 0; i < k.sec_max_len; ++i)
    s.sec_signs[i] = in.sec_signs[c * k.sec_max_len + i];
  s.sec_len = in.sec_len[c];
  s.sec_phase = in.sec_phase[c];
  s.sec_locked = in.secondary_locked[c] != 0;
}

__device__ void store_carry(const FastStatePtrs& out, int c,
                            const FastConsts& k, const FastCarry& s) {
  const int n = k.cn0_samples;
  out.active[c] = s.active;
  out.offset[c] = s.offset;
  out.rem_code_phase_samples[c] = s.rem;
  out.rem_carr_phase_rad[c] = s.rem_carr;
  out.carrier_doppler_hz[c] = s.dopp;
  out.if_freq_hz[c] = s.if_freq;
  out.code_doppler_chips[c] = s.code_dop;
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
  out.code_lock_fail[c] = s.code_fail;
  out.carrier_lock_fail[c] = s.carr_fail;
  out.loss_of_lock[c] = s.loss;
  for (int i = 0; i < 4; ++i) out.kf_x[c * 4 + i] = s.kf_x[i];
  for (int i = 0; i < 16; ++i) out.kf_p[c * 16 + i] = s.kf_p[i];
  for (int i = 0; i < 4; ++i) out.gs_niw[c * 4 + i] = s.gs_niw[i];
  for (int i = 0; i < k.sec_max_len; ++i)
    out.sec_signs[c * k.sec_max_len + i] = s.sec_signs[i];
  out.sec_len[c] = s.sec_len;
  out.sec_phase[c] = s.sec_phase;
  out.secondary_locked[c] = s.sec_locked;
}

// FastTrackingEngine.group_inputs for period kk of the group
__device__ void group_period(const FastConsts& k, const FastCarry& s, int kk,
                             GroupInputs& q) {
  const float t_frac = sub(k.t_frac_nom, mul(s.code_dop, k.t_nom_over_f0));
  const float frac = add(s.rem, mul(static_cast<float>(kk), t_frac));
  const float fl = floorf(frac);
  const int start = s.offset + kk * k.t_int + static_cast<int>(fl);
  const float rem = sub(frac, fl);
  const int win = min(max(start, 0), k.total - k.win_len);
  const float step = mul(mul(k.two_pi, add(s.dopp, s.if_freq)), k.inv_fs);
  // mid-period code-Doppler drift correction of the bank phase
  float pf_eff = sub(rem, mul(s.code_dop, k.half_t_over_f0));
  pf_eff = pf_eff < 0.0f ? 0.0f : (pf_eff > 1.0f ? 1.0f : pf_eff);
  const float pf = mul(pf_eff, k.bank_phases);
  const int j0 = min(max(static_cast<int>(floorf(pf)), 0), k.P1 - 2);
  q.start[kk] = start;
  q.rem[kk] = rem;
  q.win[kk] = win;
  q.ph0[kk] = add(s.rem_carr, mul(step, static_cast<float>(win - s.offset)));
  q.j0[kk] = j0;
  q.w[kk] = sub(pf, static_cast<float>(j0));
  if (kk == 0) {
    q.step = step;
    q.seg_win = min(max(s.offset, 0), k.total - k.lg);
    q.seg_code_step = add(k.code_step_nom, mul(s.code_dop, k.cspc_over_fs));
    q.seg_rem = s.rem;
    q.seg_rem_carr = s.rem_carr;
  }
}

// FastTrackingEngine._close_loops for one channel: cre/cim [K][NP + ND]
// the group's correlations (tap NP the data code's prompt when ND = 1);
// writes the record row [5K + 4] and the group prompt, and advances the
// carry of a channel that processes this group.
template <int NP, int ND>
__device__ void close_group(const FastConsts& k, FastCarry& s,
                            const GroupInputs& q, float* cre, float* cim,
                            float* row, float& ep_re_out, float& ep_im_out) {
  constexpr int NT = NP + ND, pt = NP / 2;
  const int K = k.K, n = k.cn0_samples;
  const bool process = s.active && s.offset < k.block_samples && !s.loss;
  // secondary wipe-off: period j's sign is sec_signs[(sec_phase + j) % len]
  if (k.sec_max_len > 1) {
    for (int j = 0; j < K; ++j) {
      const float sg = s.sec_signs[(s.sec_phase + j) % s.sec_len];
      for (int t = 0; t < NP; ++t) {
        cre[j * NT + t] = mul(cre[j * NT + t], sg);
        cim[j * NT + t] = mul(cim[j * NT + t], sg);
      }
    }
  }
  // the group sum over K as PyTorch's CUDA reduction over a strided axis
  // orders it: four running sums (period j into sum j % 4), then combined
  // in order
  float g_re[NP], g_im[NP];
  for (int t = 0; t < NP; ++t) {
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f}, b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = 0; j < K; ++j) {
      a[j & 3] = add(a[j & 3], cre[j * NT + t]);
      b[j & 3] = add(b[j & 3], cim[j * NT + t]);
    }
    g_re[t] = add(add(add(a[0], a[1]), a[2]), a[3]);
    g_im[t] = add(add(add(b[0], b[1]), b[2]), b[3]);
  }
  const float ep_re = g_re[pt], ep_im = g_im[pt];
  ep_re_out = ep_re;
  ep_im_out = ep_im;
  // the record: starts | rems | prompts | data_re | data_im | dopp cn0
  // valid loss (block-relative starts stay < 2^24, exact in float32)
  for (int j = 0; j < K; ++j) {
    row[j] = static_cast<float>(q.start[j]);
    row[K + j] = q.rem[j];
    row[2 * K + j] = cre[j * NT + pt];
    row[3 * K + j] = ND ? cre[j * NT + NP] : cre[j * NT + pt];
    row[4 * K + j] = ND ? cim[j * NT + NP] : cim[j * NT + pt];
  }
  row[5 * K + 2] = process ? 1.0f : 0.0f;
  if (!process) {
    row[5 * K] = s.dopp;
    row[5 * K + 1] = s.cn0;
    row[5 * K + 3] = s.loss ? 1.0f : 0.0f;
    return;
  }

  const float pll_rad = s.sec_locked ? atan2f(ep_im, ep_re)
                                     : pll_costas(ep_re, ep_im);
  const float pll_hz = mul(pll_rad, k.inv_two_pi);
  float dll;   // VEMLP with the five VEML taps, else E-L
  if constexpr (NP == 5)
    dll = dll_vemlp(g_re, g_im);
  else
    dll = dll_e_minus_l(g_re[0], g_im[0], g_re[2], g_im[2], k.dll_gain);

  float dopp, code_dop, code_corr = 0.0f, carr_corr = 0.0f;
  bool corrections = false;
  if (k.loop == kLoopKf) {
    // 4-state code/carrier KF closure: the discriminators are its
    // measurements, the rates come from its Doppler state
    float x[4], p[4][4], xo[4], po[4][4], d[4];
    for (int i = 0; i < 4; ++i) {
      x[i] = s.kf_x[i];
      for (int j = 0; j < 4; ++j) p[i][j] = s.kf_p[i * 4 + j];
    }
    kf_update(k.kf, x, p, dll, pll_rad, xo, po, d);
    for (int i = 0; i < 4; ++i) {
      s.kf_x[i] = xo[i];
      for (int j = 0; j < 4; ++j) s.kf_p[i * 4 + j] = po[i][j];
    }
    dopp = xo[2];
    code_dop = mul(dopp, k.aiding);
    code_corr = d[0];
    carr_corr = d[1];
    corrections = true;
  } else if (k.loop == kLoopGaussian) {
    // Gaussian carrier-KF closure on kf_x[1:1+n], kf_p[1:1+n, 1:1+n] and
    // the NIW carry; the code closes through the DLL filter as a phase
    // correction over the group
    float info[4];
    const int it = static_cast<int>(s.gs_niw[0]);
    const int n0 = static_cast<int>(s.gs_niw[1]);
    int it1, n1;
    float mu1, psi1;
    if (k.gs.order == 3) {
      float x[3], p[3][3], xo[3], po[3][3];
      for (int i = 0; i < 3; ++i) {
        x[i] = s.kf_x[1 + i];
        for (int j = 0; j < 3; ++j) p[i][j] = s.kf_p[(1 + i) * 4 + 1 + j];
      }
      gaussian_update<3>(k.gs, x, p, it, n0, s.gs_niw[2], s.gs_niw[3],
                         pll_rad, s.cn0, xo, po, it1, n1, mu1, psi1, info);
      for (int i = 0; i < 3; ++i) {
        s.kf_x[1 + i] = xo[i];
        for (int j = 0; j < 3; ++j) s.kf_p[(1 + i) * 4 + 1 + j] = po[i][j];
      }
    } else {
      float x[2], p[2][2], xo[2], po[2][2];
      for (int i = 0; i < 2; ++i) {
        x[i] = s.kf_x[1 + i];
        for (int j = 0; j < 2; ++j) p[i][j] = s.kf_p[(1 + i) * 4 + 1 + j];
      }
      gaussian_update<2>(k.gs, x, p, it, n0, s.gs_niw[2], s.gs_niw[3],
                         pll_rad, s.cn0, xo, po, it1, n1, mu1, psi1, info);
      for (int i = 0; i < 2; ++i) {
        s.kf_x[1 + i] = xo[i];
        for (int j = 0; j < 2; ++j) s.kf_p[(1 + i) * 4 + 1 + j] = po[i][j];
      }
    }
    s.gs_niw[0] = static_cast<float>(it1);
    s.gs_niw[1] = static_cast<float>(n1);
    s.gs_niw[2] = mu1;
    s.gs_niw[3] = psi1;
    dopp = info[1];
    code_dop = mul(dopp, k.aiding);
    const float code_err = iir_step(s.xh, s.yh, dll, k.dll_ic, k.dll_oc);
    code_corr = mul(code_err, k.t_group);
    carr_corr = info[0];
    corrections = true;
  } else {
    float w = s.carr_w, x = s.carr_x;
    dopp = fll_pll_step(k.pll_order, k.g, 0.0f, pll_hz, k.t_group, w, x);
    s.carr_w = w;
    s.carr_x = x;
    const float code_err = iir_step(s.xh, s.yh, dll, k.dll_ic, k.dll_oc);
    code_dop = -code_err;
    if (k.carrier_aiding) code_dop = add(code_dop, mul(dopp, k.aiding));
  }

  // ---- carry to the next group (int + small fraction) ----
  const float t_frac = sub(k.t_frac_nom, mul(s.code_dop, k.t_nom_over_f0));
  const float kt = mul(k.k_f32, t_frac);
  float frac_end = add(s.rem, kt);
  float group_len = add(k.k_t_int_f32, kt);
  if (corrections) {
    const float cs = mul(code_corr, k.fs_over_chip);
    frac_end = add(frac_end, cs);
    group_len = add(group_len, cs);
  }
  const float fl_end = floorf(frac_end);
  float carr_incr = mul(q.step, group_len);
  if (corrections) carr_incr = add(carr_incr, carr_corr);
  s.offset = s.offset + k.k_t_int + static_cast<int>(fl_end);
  s.rem = sub(frac_end, fl_end);
  s.rem_carr = remainder_f(add(s.rem_carr, carr_incr), k.two_pi);
  s.dopp = dopp;
  s.code_dop = code_dop;
  if (k.sec_max_len > 1) s.sec_phase = (s.sec_phase + K) % s.sec_len;

  // ---- C/N0 and locks (per group) ----
  for (int i = n - 1; i > 0; --i) {
    s.pb_re[i] = s.pb_re[i - 1];
    s.pb_im[i] = s.pb_im[i - 1];
  }
  s.pb_re[0] = ep_re;
  s.pb_im[0] = ep_im;
  s.p_old_re = ep_re;
  s.p_old_im = ep_im;
  const int count_pre = s.prompt_count;
  const bool have = count_pre >= n, first = count_pre == n;
  s.prompt_count = min(count_pre + 1, n + 1);
  const float cn0_raw = cn0_m2m4(s.pb_re, s.pb_im, n, k.inv_n, k.t_group);
  const float cn0 = have ? (first ? cn0_raw
                                  : add(mul(k.cn0_a, cn0_raw),
                                        mul(k.cn0_1ma, s.cn0)))
                         : s.cn0;
  const float lock_raw = carrier_lock(ep_re, ep_im);
  const float lock = have ? (first ? lock_raw
                                   : add(mul(k.lock_a, lock_raw),
                                         mul(k.lock_1ma, s.lock)))
                          : s.lock;
  const int hv = have ? 1 : 0;
  const int cfail = (have && lock < k.carrier_lock_th) ? s.carr_fail + 1
                                                       : max(s.carr_fail - hv, 0);
  const int kfail = (have && cn0 < k.cn0_min) ? s.code_fail + 1
                                              : max(s.code_fail - hv, 0);
  const bool loss = cfail > k.max_carr_fail || kfail > k.max_code_fail;
  s.cn0 = cn0;
  s.lock = lock;
  s.code_fail = loss ? 0 : kfail;
  s.carr_fail = loss ? 0 : cfail;
  s.loss = s.loss || (loss && s.active);
  row[5 * K] = dopp;
  row[5 * K + 1] = cn0;
  row[5 * K + 3] = s.loss ? 1.0f : 0.0f;
}

// The whole program of one channel (cluster c of S blocks): per group
// the leader's prologue, the correlation of the K periods (K1's bank
// body or, SEG, K1-seg's segmented sum), period j by block j mod S (each
// period whole on one block, K1's own layout), each period's sums
// written into the leader's shared memory, then the leader's closure and
// record. Two cluster barriers a group: after the prologue, after the
// periods' sums.
template <typename T, int NP, int ND, bool SEG>
__device__ __forceinline__ void fast_loop_body(
    const T* __restrict__ src_re, const T* __restrict__ src_im,
    long long base, const float* __restrict__ bank, const FastStatePtrs& in,
    const FastStatePtrs& out, const FastConsts& k, float* __restrict__ packed,
    float* __restrict__ prompt_re, float* __restrict__ prompt_im) {
  constexpr int NT = NP + ND;
  extern __shared__ float s_tab[];   // SEG: the channel's pilot code table
  __shared__ float scratch[4 * NT * 32];
  __shared__ FastCarry st;           // the leader's
  __shared__ GroupInputs q;          // the leader's; the others' copies
  __shared__ float s_cre[kMaxK * NT], s_cim[kMaxK * NT];   // the leader's
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const bool lead = r == 0;
  const int c = blockIdx.x / S, C = gridDim.x / S;
  if (lead && threadIdx.x == 0) load_carry(in, c, k, st);
  // K1: the channel's bank rows [P + 1][NT][W]; K1-seg: its tables
  // [1 + ND][table_len], the pilot's staged in shared memory
  const float* bank_c = SEG ? bank + (size_t)c * (1 + ND) * k.table_len
                            : bank + (size_t)c * k.P1 * NT * (size_t)k.W;
  float sh[NP];
  if constexpr (SEG) {
    for (int i = threadIdx.x; i < k.table_len; i += blockDim.x)
      s_tab[i] = bank_c[i];
#pragma unroll
    for (int t = 0; t < NP; ++t) sh[t] = k.shifts[t];
  }
  const GroupInputs* lead_q = cluster.map_shared_rank(&q, 0);
  float* lead_cre = cluster.map_shared_rank(s_cre, 0);
  float* lead_cim = cluster.map_shared_rank(s_cim, 0);
  __syncthreads();
  const int row_w = 5 * k.K + 4;
  for (int b = 0; b < k.n_blocks; ++b) {
    const long long bb = base + (long long)b * k.block_stride;
    for (int g = 0; g < k.n_groups; ++g) {
      if (lead) {
        for (int j = threadIdx.x; j < k.K; j += blockDim.x)
          group_period(k, st, j, q);
      }
      cluster.sync();   // the group's inputs published
      if (!lead) {
        for (int j = threadIdx.x; j < k.K; j += blockDim.x) {
          q.win[j] = lead_q->win[j];
          q.j0[j] = lead_q->j0[j];
          q.ph0[j] = lead_q->ph0[j];
          q.w[j] = lead_q->w[j];
        }
        if (threadIdx.x == 0) {
          q.step = lead_q->step;
          q.seg_win = lead_q->seg_win;
          q.seg_code_step = lead_q->seg_code_step;
          q.seg_rem = lead_q->seg_rem;
          q.seg_rem_carr = lead_q->seg_rem_carr;
        }
        __syncthreads();
      }
      for (int j = r; j < k.K; j += S) {
        if constexpr (SEG) {
          float acc[2 * NT];
          seg_accumulate<T, NP, ND>(src_re, src_im, bb + q.seg_win, k.lg, j,
                                    k.K, k.table_len, s_tab,
                                    bank_c + k.table_len, sh, q.seg_rem,
                                    q.seg_code_step, q.seg_rem_carr, q.step,
                                    acc, threadIdx.x, blockDim.x);
          block_sum<2 * NT>(acc, scratch);
          if (threadIdx.x == 0) {
#pragma unroll
            for (int t = 0; t < NT; ++t) {
              lead_cre[j * NT + t] = acc[t < NP ? t : 2 * NP];
              lead_cim[j * NT + t] = acc[t < NP ? NP + t : 2 * NP + 1];
            }
          }
        } else {
          const float* b0 = bank_c + (size_t)q.j0[j] * NT * k.W;
          float acc[4 * NT];
          k1_accumulate<T, NT>(src_re, src_im, bb + q.win[j], q.ph0[j],
                               q.step, b0, b0 + (size_t)NT * k.W, k.W,
                               k.n_eff, acc, threadIdx.x, blockDim.x);
          block_sum<4 * NT>(acc, scratch);
          if (threadIdx.x == 0)
            k1_interp<NT>(acc, q.w[j], lead_cre + j * NT, lead_cim + j * NT);
        }
        __syncthreads();   // scratch is free for the next period
      }
      cluster.sync();   // every period's sums with the leader
      if (lead && threadIdx.x == 0) {
        const size_t bg = (size_t)b * k.n_groups + g;
        close_group<NP, ND>(k, st, q, s_cre, s_cim,
                            packed + (bg * C + c) * row_w,
                            prompt_re[bg * C + c], prompt_im[bg * C + c]);
        // after a block's last group its offsets are rebased
        if (g == k.n_groups - 1 && st.active) st.offset -= k.block_samples;
      }
      __syncthreads();   // the leader's carry before the next prologue
    }
  }
  if (lead && threadIdx.x == 0) store_carry(out, c, k, st);
}

// K1-loop with the code bank (the production correlator)
template <typename T, int NP, int ND>
__global__ void __launch_bounds__(kThreads)
fast_loop_kernel(const T* __restrict__ src_re, const T* __restrict__ src_im,
                 long long base, const float* __restrict__ bank,
                 FastStatePtrs in, FastStatePtrs out, FastConsts k,
                 float* __restrict__ packed, float* __restrict__ prompt_re,
                 float* __restrict__ prompt_im) {
  fast_loop_body<T, NP, ND, false>(src_re, src_im, base, bank, in, out, k,
                                   packed, prompt_re, prompt_im);
}

// K1-loop with the segmented sum (K1-seg) as its correlation body
template <typename T, int NP, int ND>
__global__ void __launch_bounds__(kThreads)
fast_loop_seg_kernel(const T* __restrict__ src_re,
                     const T* __restrict__ src_im, long long base,
                     const float* __restrict__ tables, FastStatePtrs in,
                     FastStatePtrs out, FastConsts k,
                     float* __restrict__ packed,
                     float* __restrict__ prompt_re,
                     float* __restrict__ prompt_im) {
  fast_loop_body<T, NP, ND, true>(src_re, src_im, base, tables, in, out, k,
                                  packed, prompt_re, prompt_im);
}

template <typename T>
using FastKernel = void (*)(const T*, const T*, long long, const float*,
                            FastStatePtrs, FastStatePtrs, FastConsts, float*,
                            float*, float*);

template <typename T, int NP, int ND>
FastKernel<T> fast_kernel_of(bool seg) {
  return seg ? fast_loop_seg_kernel<T, NP, ND> : fast_loop_kernel<T, NP, ND>;
}

// the kernel instance of the taps (NP), the data prompt (ND) and the
// correlator
template <typename T>
FastKernel<T> fast_kernel(int n_taps, int track_pilot, bool seg) {
  switch (n_taps * 2 + (track_pilot ? 1 : 0)) {
    case 6: return fast_kernel_of<T, 3, 0>(seg);
    case 7: return fast_kernel_of<T, 3, 1>(seg);
    case 10: return fast_kernel_of<T, 5, 0>(seg);
    case 11: return fast_kernel_of<T, 5, 1>(seg);
    default: return nullptr;
  }
}

// dynamic shared memory: K1-seg's pilot table (K1 needs none)
size_t fast_smem(bool seg, int table_len) {
  return seg ? sizeof(float) * table_len : 0;
}

// The cluster size of a K-period group: the fewest rounds of periods
// over at most kMaxCluster blocks (kPortableCluster where each block
// holds more than 48 KB of table, one block an SM), the periods then
// spread evenly: K = 20 -> 10 blocks of 2 periods, K = 25 -> 13 blocks
// (12 of 2, one of 1). Each period is one block's whole, so the size
// changes no bit of the result.
int fast_cluster(int K, size_t smem) {
  const int cap = smem > kSmemNoOptIn ? kPortableCluster : kMaxCluster;
  const int rounds = (K + cap - 1) / cap;
  return (K + rounds - 1) / rounds;
}

template <typename T>
int launch(const T* re, const T* im, long long base, const float* bank,
           int n_taps, int track_pilot, FastStatePtrs in, FastStatePtrs out,
           FastConsts k, float* packed, float* prompt_re, float* prompt_im,
           int C, cudaStream_t stream) {
  const FastKernel<T> kern = fast_kernel<T>(n_taps, track_pilot, k.seg != 0);
  if (kern == nullptr || k.cn0_samples < 1 || k.cn0_samples > kMaxCn0 ||
      k.K < 1 || k.K > kMaxK || k.sec_max_len < 1 ||
      k.sec_max_len > kMaxSec || C < 1 ||
      (k.loop == kLoopGaussian && k.gs.order != 2 && k.gs.order != 3) ||
      (k.seg && (k.table_len < 1 || k.lg < 1 || k.lg > k.total)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fast_smem(k.seg != 0, k.table_len);
  return cluster_launch(kern, C, fast_cluster(k.K, smem), kThreads, smem,
                        stream, re, im, base, bank, in, out, k, packed,
                        prompt_re, prompt_im);
}

}  // namespace

extern "C" {

// int8 planar ring (superblock_ring_i8); the widening folded into the load
int fast_loop_i8(const int8_t* re, const int8_t* im, long long base,
                 const float* bank, int n_taps, int track_pilot,
                 FastStatePtrs in, FastStatePtrs out, FastConsts k,
                 float* packed, float* prompt_re, float* prompt_im, int C,
                 void* stream) {
  return launch<int8_t>(re, im, base, bank, n_taps, track_pilot, in, out, k,
                        packed, prompt_re, prompt_im, C,
                        static_cast<cudaStream_t>(stream));
}

// float32 planes (process_block)
int fast_loop_f32(const float* re, const float* im, long long base,
                  const float* bank, int n_taps, int track_pilot,
                  FastStatePtrs in, FastStatePtrs out, FastConsts k,
                  float* packed, float* prompt_re, float* prompt_im, int C,
                  void* stream) {
  return launch<float>(re, im, base, bank, n_taps, track_pilot, in, out, k,
                       packed, prompt_re, prompt_im, C,
                       static_cast<cudaStream_t>(stream));
}

// K1-loop's cluster on the current card (the bank body, or seg != 0 the
// segmented sum on tables of table_len entries): its size S for K-period
// groups and cudaOccupancyMaxActiveClusters.
int fast_loop_cluster(int n_taps, int track_pilot, int i8, int seg, int K,
                      int table_len, int* S, int* n_active) {
  const size_t smem = fast_smem(seg != 0, table_len);
  const int s = fast_cluster(K, smem);
  *S = s;
  if (i8) {
    const FastKernel<int8_t> kern =
        fast_kernel<int8_t>(n_taps, track_pilot, seg != 0);
    if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return cluster_occupancy(kern, s, kThreads, smem, n_active);
  }
  const FastKernel<float> kern =
      fast_kernel<float>(n_taps, track_pilot, seg != 0);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return cluster_occupancy(kern, s, kThreads, smem, n_active);
}

}  // extern "C"
