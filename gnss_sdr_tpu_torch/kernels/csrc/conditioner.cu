// K7: the signal conditioner's device programs (sm_90a).
//
// Replaces the jitted programs of gnss_sdr_tpu/conditioner/:
//   K7a fir.py::fir_filter, fir.py::freq_xlating_fir_filter and the
//       translation NCO of chain.py::SignalConditionerChain._apply_planar
//       (fir_decim_kernel);
//   K7b interference.py::pulse_blanking (power_partials_kernel,
//       blank_threshold_kernel, blank_kernel);
//   K7c interference.py::notch_filter_block, the part around the two FFTs
//       (notch_sample_kernel, notch_bracket_kernel, notch_select_kernel,
//       notch_kernel); the FFTs stay on cuFFT (torch.fft);
//   K7d resampler.py::mmse_resample and the Direct_Resampler gather of
//       chain.py (resample_kernel);
//   K7e beamformer.py::beamform, the antenna-array combiner of
//       BeamformerFilter (beamform_kernel): y = sum_m w_m x_m over the
//       M antenna channels, as JAX's four einsums then their difference
//       and sum.
//
// All samples are interleaved complex64 (float2). K7b, K7d and K7e read
// each input once and write each output once, bound by HBM bytes at the
// conditioner's shapes (tens of millions of samples):
//   K7a computes only the kept (every D-th) outputs from a shared-memory
//       tile of translated inputs, each input loaded and translated once
//       per tile (the ntaps-1 halo between tiles is the only repeat), no
//       cos/sin table in device memory. At 65 taps its float32 arithmetic
//       bounds it (two products and two sums rounded apart a tap and
//       output: 12.5 G float32 instructions at 48 M outputs, ~0.4 ms),
//       not its bytes: a thread computes 8 consecutive outputs from
//       register windows over the tile's polyphase planes, one conflict-
//       free shared-memory load a tap for 8 outputs; the next tile's
//       inputs are copied while the taps run; the NCO's fmod is one fused
//       multiply-add, its sincos one a thread and tile, rotated between.
//   K7b reduces the block's mean power in float64 in two fixed-order
//       passes (block partials, then one block over the partials): no
//       float atomics, so the threshold is the same on every run.
//   K7c finds the two middle order statistics of |X| from a sample's
//       bracket in two reads of the spectrum, the second of which masks
//       (below, at notch_sample_kernel).
//   K7d computes each output position from its integer index in float64.
//   K7e makes one pass, 8 M N bytes read, 8 N written (~86 us at M = 8,
//       N = 4 M). It reads the capture as the card holds it, interleaved
//       complex64 [M, N]: a thread takes two samples, one 16-byte load
//       from each of the M rows (up to 8 in flight at once, each asking
//       L2 for its whole 256-byte block) and one 16-byte store. Planar or
//       misaligned input takes one sample a thread with the same
//       arithmetic.
//
// Rounding: products and sums the plain PyTorch version computes as
// separate roundings are written with __f*_rn (no FMA contraction); the
// NCO phase and the resampler positions are float64 on the absolute
// integer index (a float32 index loses integer precision past 2^24).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// 2.0 * np.pi exactly: the literal is the shortest repr of np.pi
constexpr double kTwoPi = 2.0 * 3.141592653589793;

// ---------------------------------------------------------------- K7a ----

// fmod(p, kTwoPi) without fmod's long division: the remainder
// p - q kTwoPi is exact in float64 for the true quotient q, so one
// fused multiply-add gives fmod's bits once q is right. q is estimated
// from |p| / (2 pi), off by at most one below 2^50, and corrected by the
// sign of the remainder; beyond that fmod itself runs.
__device__ __forceinline__ double mod_two_pi(double p) {
  constexpr double kInvTwoPi = 1.0 / kTwoPi;
  const double a = fabs(p);
  double r;
  if (a < 0x1p50) {
    double q = trunc(a * kInvTwoPi);
    r = __fma_rn(-q, kTwoPi, a);
    if (r < 0.0) {
      q -= 1.0;
      r = __fma_rn(-q, kTwoPi, a);
    } else if (r >= kTwoPi) {
      q += 1.0;
      r = __fma_rn(-q, kTwoPi, a);
    }
  } else {
    r = fmod(a, kTwoPi);
  }
  return copysign(r, p);
}

// e^{j phi} of the translation NCO at absolute input index n, with
// phi = mod(step * n, 2 pi) in float64 (np.mod semantics: result in
// [0, 2 pi)), in float64.
__device__ __forceinline__ void nco(double step, long long n, double& c,
                                    double& s) {
  double r = mod_two_pi(__dmul_rn(step, static_cast<double>(n)));
  if (r < 0.0) r = __dadd_rn(r, kTwoPi);
  sincos(r, &s, &c);
}

// Outputs a thread: R consecutive ones (kFirOut) for D <= kFirMaxD, one
// for a larger D.
constexpr int kFirOut = 8;
constexpr int kFirMaxD = 4;
// threads a block: two 1024-output tiles at D = 2 and 65 taps take 38 KB,
// so four or five blocks share an SM (256-thread ones took 74 KB: two)
constexpr int kFirThreads = 128;

__host__ __device__ constexpr int fir_outputs(int d) {
  return d <= kFirMaxD ? kFirOut : 1;
}

// The tile's polyphase planes: plane s holds P_s[i] = x'[i D - s], so
// that tap j = q D + s of output k reads P_s[k - q]. Local index li of a
// plane lies at li + li / R: one float2 of padding after every R, which
// puts the R-strided reads of a warp's threads in distinct banks.
__host__ __device__ constexpr int fir_plane_stride(int len, int r) {
  return r > 1 ? len + len / r : len;
}

// An 8-byte asynchronous copy from global to shared memory; ``bytes`` 0
// fills the destination with zeros instead.
__device__ __forceinline__ void cp_async8(float2* dst, const float2* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   static_cast<unsigned int>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for every group of this thread's copies but the newest.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// acc += v * tj, the product and the sum rounded apart (the plain
// version's y += x * tap)
__device__ __forceinline__ void fir_add(float& ar, float& ai, float2 v,
                                        float tj) {
  ar = __fadd_rn(ar, __fmul_rn(v.x, tj));
  ai = __fadd_rn(ai, __fmul_rn(v.y, tj));
}

// Tap runs q0 .. q0 + R - 1 of a thread's R outputs: run q's taps
// j = q D + s, in order, each loading P_s[li0 - q] into its window slot
// and adding to every output. ``p`` points at the physical place of
// li0 - q0 = m R in plane 0: li = m R - u lies at m (R + 1) - u - (u > 0).
// kGuard skips the taps past n_taps (the last runs).
template <int kD, int R, bool kGuard>
__device__ __forceinline__ void fir_runs(float2 (&w)[kD][R], float (&ar)[R],
                                         float (&ai)[R], const float2* p,
                                         int stride,
                                         const float* __restrict__ s_taps,
                                         int q0, int n_taps) {
#pragma unroll
  for (int u = 0; u < R; ++u) {
#pragma unroll
    for (int s = 0; s < kD; ++s) {
      const int j = (q0 + u) * kD + s;
      if (kGuard && j >= n_taps) continue;
      w[s][(R - u) % R] = p[s * stride - u - (u > 0 ? 1 : 0)];
      const float tj = s_taps[j];
#pragma unroll
      for (int r = 0; r < R; ++r)
        fir_add(ar[r], ai[r], w[s][(r - u + R) % R], tj);
    }
  }
}

// A thread's R outputs of the tile in ``s_x``: output r accumulates tap
// j = q D + s of P_s[li0 + r - q] for q < n_q, in tap order.
template <int kD, int R>
__device__ __forceinline__ void fir_tile(const float2* s_x, int stride,
                                         const float* __restrict__ s_taps,
                                         int n_taps, int D, int n_q,
                                         int q_pad, float (&ar)[R],
                                         float (&ai)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) ar[r] = ai[r] = 0.0f;
  if constexpr (kD == 0) {
    // output t of the tile: tap q D + s reads P_s[t - q + q_pad]
    for (int q = 0; q < n_q; ++q) {
      const float2* p = s_x + threadIdx.x - q + q_pad;
      for (int s = 0; s < D && q * D + s < n_taps; ++s)
        fir_add(ar[0], ai[0], p[s * stride], s_taps[q * D + s]);
    }
  } else {
    // w[s][li mod R] = P_s[li]
    const int li0 = threadIdx.x * R + q_pad;
    float2 w[kD][R];
#pragma unroll
    for (int s = 0; s < kD; ++s)
#pragma unroll
      for (int r = 1; r < R; ++r)
        w[s][r] = s_x[s * stride + (li0 / R) * (R + 1) + r];
    int q0 = 0;
    for (; (q0 + R) * kD <= n_taps; q0 += R)
      fir_runs<kD, R, false>(w, ar, ai, s_x + ((li0 - q0) / R) * (R + 1),
                             stride, s_taps, q0, n_taps);
    if (q0 < n_q)
      fir_runs<kD, R, true>(w, ar, ai, s_x + ((li0 - q0) / R) * (R + 1),
                            stride, s_taps, q0, n_taps);
  }
}

// y[k] = sum_j taps[j] * x'[k*decim - j] for k < n_out, x'[n] = 0 for
// n < 0 and x'[n] = x[n] e^{j phi(n0 + n)} (or x[n] without translation),
// the taps summed in order, each product and sum rounded apart.
//
// Tile b holds the outputs [b T, (b + 1) T), T = blockDim.x R; thread t
// computes the R outputs from b T + t R. A tile's inputs lie in shared
// memory as D polyphase planes of q_pad + T inputs each (q_pad: the tap
// runs Q = ceil(n_taps / D) rounded up to R), every input once. For a
// compile-time D each thread keeps, per plane, a window of the R inputs
// its R outputs read at the current run q in registers: one shared-
// memory load per tap feeds R outputs (the old kernel made one, 16 bytes
// apart across a warp, per output and tap). Element li of a window sits
// in register slot li mod R, so with the run loop unrolled by R every
// slot index is a constant. A larger D (kD = 0) reads every input from
// its plane, one output a thread.
//
// The blocks are persistent (as many as fit at once, tiles b, b + grid,
// ...) and keep two tiles: cp.async copies tile i + 1's inputs straight
// to their plane slots (zeros outside [0, n_in)) while tile i's taps
// run. Each thread then translates the inputs it copied, blockDim.x
// apart: the float64 NCO (fmod and sincos) at its first, a float64
// rotation by e^{j step blockDim.x} (two products, two fused multiply-
// adds) for each next one; a sincos a sample took as long as the taps.
// The rotation moves a phase from the plain version's, rounded from
// step * n, by up to an ulp of step * n (1.5e-8 rad at n = 96 M), so cos
// and sin round to float32 an ulp apart at times.
template <int kD, bool kTranslate>
__global__ void __launch_bounds__(kFirThreads)
fir_decim_kernel(const float2* __restrict__ x, long long n_in,
                 const float* __restrict__ taps, int n_taps, int decim,
                 double nco_step, long long n0, int q_pad,
                 float2* __restrict__ y, long long n_out) {
  constexpr int R = fir_outputs(kD > 0 ? kD : kFirMaxD + 1);
  const int D = kD > 0 ? kD : decim;
  extern __shared__ float smem[];
  float* s_taps = smem;
  float2* s_buf = reinterpret_cast<float2*>(smem + ((n_taps + 1) & ~1));
  const int tile = blockDim.x * R;
  const int n_q = (n_taps + D - 1) / D;
  const int stride = fir_plane_stride(q_pad + tile, R);
  const long long n_tiles = (n_out + tile - 1) / tile;
  // tile ti's inputs: n = (ti T - q_pad) D + nr for nr in
  // [nr_lo, nr_lo + span), nr_lo = (q_pad - n_q) D + 1
  const int nr_lo = (q_pad - n_q) * D + 1;
  const int span = (n_q + tile - 1) * D;
  auto slot = [&](int e) {
    const int nr = nr_lo + e;
    const int s = (D - nr % D) % D;
    const int li = (nr + s) / D;
    return s * stride + (R > 1 ? li + li / R : li);
  };
  auto first = [&](long long ti) { return (ti * tile - q_pad) * D + nr_lo; };
  // thread t copies (and translates) the inputs e = t + i blockDim.x of a
  // tile; their slots advance by a constant when blockDim.x is a
  // multiple of D R (D = 1, 2, 4 at 128 threads)
  const bool even = blockDim.x % (D * R) == 0;
  const int slot_step =
      even ? slot(threadIdx.x + blockDim.x) - slot(threadIdx.x) : 0;
  auto fetch = [&](long long ti, float2* buf) {
    const long long n = first(ti);
    const bool inside = n >= 0 && n + span <= n_in;
    int at = slot(threadIdx.x);
    for (int e = threadIdx.x; e < span; e += blockDim.x, at += slot_step) {
      const bool in = inside || (n + e >= 0 && n + e < n_in);
      cp_async8(buf + (even ? at : slot(e)), in ? x + n + e : x, in ? 8 : 0);
    }
  };
  for (int i = threadIdx.x; i < n_taps; i += blockDim.x) s_taps[i] = taps[i];
  // e^{j step blockDim.x}: the phase advance between a thread's inputs
  double rot_s = 0.0, rot_c = 1.0;
  if (kTranslate)
    sincos(__dmul_rn(nco_step, static_cast<double>(blockDim.x)), &rot_s,
           &rot_c);
  long long ti = blockIdx.x;
  if (ti < n_tiles) fetch(ti, s_buf);
  cp_async_commit();
  for (int it = 0; ti < n_tiles; ++it, ti += gridDim.x) {
    float2* cur = s_buf + (it & 1) * D * stride;
    if (ti + gridDim.x < n_tiles)
      fetch(ti + gridDim.x, s_buf + ((it + 1) & 1) * D * stride);
    cp_async_commit();
    cp_async_wait_prior();
    if (kTranslate) {
      // the inputs this thread copied: the first in [0, n_in) from the
      // NCO, each next by rotating the float64 phasor; the products
      // rounded as the plain version's
      const long long n = first(ti);
      int at = slot(threadIdx.x);
      double c = 0.0, sn = 0.0;
      bool on = false;
      for (int e = threadIdx.x; e < span; e += blockDim.x, at += slot_step) {
        if (n + e < 0 || n + e >= n_in) continue;
        if (on) {
          const double c1 = __fma_rn(c, rot_c, -__dmul_rn(sn, rot_s));
          sn = __fma_rn(c, rot_s, __dmul_rn(sn, rot_c));
          c = c1;
        } else {
          nco(nco_step, n0 + n + e, c, sn);
          on = true;
        }
        const float cf = __double2float_rn(c), sf = __double2float_rn(sn);
        float2& v = cur[even ? at : slot(e)];
        v = make_float2(__fsub_rn(__fmul_rn(v.x, cf), __fmul_rn(v.y, sf)),
                        __fadd_rn(__fmul_rn(v.x, sf), __fmul_rn(v.y, cf)));
      }
    }
    __syncthreads();
    float ar[R], ai[R];
    fir_tile<kD, R>(cur, stride, s_taps, n_taps, D, n_q, q_pad, ar, ai);
    const long long k = ti * tile + static_cast<long long>(threadIdx.x) * R;
    if (R % 2 == 0 && k + R <= n_out &&
        (reinterpret_cast<uintptr_t>(y) & 15) == 0) {
#pragma unroll
      for (int r = 0; r < R; r += 2)
        reinterpret_cast<float4*>(y + k)[r / 2] =
            make_float4(ar[r], ai[r], ar[r + 1], ai[r + 1]);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (k + r < n_out) y[k + r] = make_float2(ar[r], ai[r]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- K7b ----

__device__ __forceinline__ float power(float2 v) {
  return __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
}

// Sum of one double per thread over the block; valid in thread 0.
__device__ __forceinline__ double block_sum_f64(double v) {
  __shared__ double scratch[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < n_warps ? scratch[lane] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// partials[b] = sum of |x|^2 (float32 products, float64 sum) over the
// grid-stride elements of block b; the assignment depends on n only.
__global__ void __launch_bounds__(kThreads)
power_partials_kernel(const float2* __restrict__ x, long long n,
                      double* __restrict__ partials) {
  double acc = 0.0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    acc += static_cast<double>(power(x[i]));
  acc = block_sum_f64(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

// thr = sigma2 * float32(sum / n): one block over the partials
__global__ void __launch_bounds__(kThreads)
blank_threshold_kernel(const double* __restrict__ partials, int n_parts,
                       long long n, float sigma2, float* __restrict__ thr) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n_parts; i += blockDim.x) acc += partials[i];
  acc = block_sum_f64(acc);
  if (threadIdx.x == 0)
    *thr = __fmul_rn(sigma2,
                     __double2float_rn(acc / static_cast<double>(n)));
}

__global__ void __launch_bounds__(kThreads)
blank_kernel(const float2* __restrict__ x, long long n,
             const float* __restrict__ thr, float2* __restrict__ y) {
  const float t = *thr;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float2 v = x[i];
    y[i] = power(v) <= t ? v : make_float2(0.0f, 0.0f);
  }
}

// ---------------------------------------------------------------- K7c ----

// The median's two ranks k_lo, k_hi of |X| (its float bits as keys:
// magnitudes are non-negative, so the bits order as the floats) in two
// reads of the spectrum, then the mask in a third:
//   1. notch_sample_kernel (one block): the keys of kNotchSample bins at
//      s n / m, s < m; an in-block radix select of that sample at the
//      ranks k m / n -+ kNotchMargin brackets both targets: [lo, hi];
//   2. notch_bracket_kernel (read n bins): counts the keys below lo,
//      equal to lo and equal to hi, and appends those strictly inside
//      to a candidate buffer (a few percent of n, read again from L2),
//      a warp's appends staged in shared memory; its last block places
//      each target: lo, hi, a rank among the candidates, or, when the
//      bracket missed it or the buffer overflowed, a rank over all n;
//   3. notch_select_kernel x 4 (8-bit digits, shared-memory histograms
//      with warp-aggregated atomics, the last block of a pass taking the
//      digit): over the candidates, or over all n bins (the keys
//      recomputed from the spectrum) after a miss; a pass with nothing
//      to select, or whose digit lo and hi share, returns at once;
//   4. notch_kernel: the threshold from the two keys, |X| recomputed,
//      the excised bins zeroed (in place: only those written).
// No magnitude buffer exists: 16 n bytes in place, 24 n into a new
// tensor, against 48 n for the four radix passes over a stored |X|.
constexpr int kNotchSample = 8192;
constexpr int kNotchSampleThreads = 1024;
constexpr int kWarpBuf = 256;

struct NotchSel {
  unsigned int lo, hi;                     // bracket keys
  unsigned int below, eq_lo, mid, eq_hi;   // the bracket pass's counts
  unsigned int route;                      // 1: selected over all n bins
  unsigned int need[2];                    // target t is radix-selected
  unsigned int key[2];                     // prefix, then key of target t
  unsigned int rank[2];                    // rank of t within its prefix
  unsigned int done;                       // blocks finished in a pass
  unsigned int first_pass;                 // the passes before it are known
  unsigned int hist[512];                  // the two targets' histograms
};

__device__ __forceinline__ unsigned int mag_key(float2 v) {
  return __float_as_uint(sqrtf(power(v)));
}

// Add one to h[bin] for each lane with ``valid``, one atomic per
// distinct bin of the warp. Every lane of the warp calls it.
__device__ __forceinline__ void hist_add(unsigned int* h, unsigned int bin,
                                         bool valid) {
  const unsigned int peers =
      __match_any_sync(0xffffffffu, valid ? bin : 0xffffffffu);
  if (valid && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&h[bin], __popc(peers));
}

// For each target t with ``need[t]``: the digit at ``shift`` whose bin of
// h[256 t ..] holds its rank; extend its prefix, make the rank relative
// to that bin. One thread per target.
__device__ __forceinline__ void radix_step(const unsigned int* h,
                                           unsigned int& prefix,
                                           unsigned int& rank, int shift) {
  unsigned int below = 0u;
  int d = 0;
  for (; d < 255; ++d) {
    if (below + h[d] > rank) break;
    below += h[d];
  }
  prefix |= static_cast<unsigned int>(d) << shift;
  rank -= below;
}

__device__ constexpr unsigned int digit_mask(int pass) {
  return pass == 0 ? 0u : 0xffffffffu << (32 - 8 * pass);
}

// Stage 1. ``r_lo``, ``r_hi``: the bracket's ranks in the sample; lo is
// 0 below rank 0 and hi is 0xffffffff past the last.
__global__ void __launch_bounds__(kNotchSampleThreads)
notch_sample_kernel(const float2* __restrict__ spec, long long n, int m,
                    int r_lo, int r_hi, NotchSel* sel) {
  __shared__ unsigned int keys[kNotchSample];
  __shared__ unsigned int h[512];
  __shared__ unsigned int st[4];   // prefix 0, prefix 1, rank 0, rank 1
  for (int s = threadIdx.x; s < m; s += blockDim.x)
    keys[s] = mag_key(spec[static_cast<long long>(s) * n / m]);
  if (threadIdx.x == 0) {
    st[0] = st[1] = 0u;
    st[2] = static_cast<unsigned int>(max(r_lo, 0));
    st[3] = static_cast<unsigned int>(min(r_hi, m - 1));
    sel->below = sel->eq_lo = sel->mid = sel->eq_hi = 0u;
    sel->route = sel->done = 0u;
  }
  for (int i = threadIdx.x; i < 512; i += blockDim.x) sel->hist[i] = 0u;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const unsigned int hm = digit_mask(pass);
    for (int i = threadIdx.x; i < 512; i += blockDim.x) h[i] = 0u;
    __syncthreads();
    const unsigned int p0 = st[0], p1 = st[1];
    for (int i0 = 0; i0 < m; i0 += blockDim.x) {
      const int i = i0 + threadIdx.x;
      const unsigned int key = i < m ? keys[i] : 0u;
      const unsigned int d = (key >> shift) & 255u;
      hist_add(h, d, i < m && (key & hm) == p0);
      hist_add(h, 256 + d, i < m && (key & hm) == p1);
    }
    __syncthreads();
    if (threadIdx.x < 2)
      radix_step(h + 256 * threadIdx.x, st[threadIdx.x], st[2 + threadIdx.x],
                 shift);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    sel->lo = r_lo < 0 ? 0u : st[0];
    sel->hi = r_hi > m - 1 ? 0xffffffffu : st[1];
  }
}

// True in every thread of the one block that finishes a pass last; its
// reads then see every other block's atomics.
__device__ __forceinline__ bool last_block(unsigned int* done) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Stage 2; ``cap`` candidates fit in ``cand``.
__global__ void __launch_bounds__(kThreads)
notch_bracket_kernel(const float2* __restrict__ spec, long long n,
                     unsigned int* __restrict__ cand, unsigned int cap,
                     unsigned int k_lo, unsigned int k_hi, NotchSel* sel) {
  __shared__ unsigned int buf[kThreads / 32][kWarpBuf];
  const unsigned int lo = sel->lo, hi = sel->hi;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned int* wb = buf[warp];
  unsigned int below = 0u, eq_lo = 0u, eq_hi = 0u;
  int held = 0;   // keys staged in wb (the same in every lane)
  auto flush = [&]() {
    __syncwarp();
    unsigned int at = 0u;
    if (lane == 0) at = atomicAdd(&sel->mid, static_cast<unsigned int>(held));
    at = __shfl_sync(0xffffffffu, at, 0);
    for (int i = lane; i < held; i += 32)
      if (at + i < cap) cand[at + i] = wb[i];
    __syncwarp();
    held = 0;
  };
  constexpr int kUnroll = 8;   // loads in flight a lane
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long b = (static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                      warp) * 32 * kUnroll;
       b < n; b += warps * 32 * kUnroll) {
    float2 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = b + u * 32 + lane;
      v[u] = i < n ? spec[i] : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = b + u * 32 + lane < n;
      const unsigned int key = mag_key(v[u]);
      below += ok && key < lo;
      eq_lo += ok && key == lo;
      eq_hi += ok && key == hi && hi != lo;
      const bool in = ok && lo < key && key < hi;
      const unsigned int ball = __ballot_sync(0xffffffffu, in);
      if (in) wb[held + __popc(ball & ((1u << lane) - 1u))] = key;
      held += __popc(ball);
      if (held > kWarpBuf - 32) flush();
    }
  }
  if (held) flush();
  below = __reduce_add_sync(0xffffffffu, below);
  eq_lo = __reduce_add_sync(0xffffffffu, eq_lo);
  eq_hi = __reduce_add_sync(0xffffffffu, eq_hi);
  if (lane == 0) {
    atomicAdd(&sel->below, below);
    atomicAdd(&sel->eq_lo, eq_lo);
    atomicAdd(&sel->eq_hi, eq_hi);
  }
  if (!last_block(&sel->done) || threadIdx.x != 0) return;
  // place each target: lo, a candidate rank, hi, or a miss
  volatile NotchSel* vs = sel;
  const unsigned int c_lo = vs->below, c_eq = vs->eq_lo, c_mid = vs->mid,
                     c_hi = vs->eq_hi;
  bool miss = false;
  unsigned int need[2], key[2], rank[2];
  for (int t = 0; t < 2; ++t) {
    const unsigned int k = t ? k_hi : k_lo;
    need[t] = 0u;
    rank[t] = 0u;
    if (k < c_lo) {
      miss = true;
    } else if (k - c_lo < c_eq) {
      key[t] = lo;
    } else if (k - c_lo - c_eq < c_mid) {
      miss |= c_mid > cap;
      need[t] = 1u;
      key[t] = 0u;
      rank[t] = k - c_lo - c_eq;
    } else if (k - c_lo - c_eq - c_mid < c_hi) {
      key[t] = hi;
    } else {
      miss = true;
    }
  }
  // a candidate lies strictly between lo and hi: it has their common
  // leading bytes, whose passes the select skips
  int first = 0;
  while (first < 4 && (lo ^ hi) >> (24 - 8 * first) == 0u) ++first;
  for (int t = 0; t < 2; ++t)
    if (need[t]) key[t] = lo & digit_mask(first);
  if (miss) {
    need[0] = need[1] = 1u;
    key[0] = key[1] = 0u;
    rank[0] = k_lo;
    rank[1] = k_hi;
    first = 0;
  }
  vs->first_pass = static_cast<unsigned int>(first);
  for (int t = 0; t < 2; ++t) {
    vs->need[t] = need[t];
    vs->key[t] = key[t];
    vs->rank[t] = rank[t];
  }
  vs->route = miss ? 1u : 0u;
  vs->done = 0u;
}

// Stage 3, pass ``pass`` of four.
__global__ void __launch_bounds__(kThreads)
notch_select_kernel(const float2* __restrict__ spec, long long n,
                    const unsigned int* __restrict__ cand, NotchSel* sel,
                    int pass) {
  const bool need0 = sel->need[0] != 0u, need1 = sel->need[1] != 0u;
  if ((!need0 && !need1) || pass < static_cast<int>(sel->first_pass))
    return;
  __shared__ unsigned int h[512];
  const bool all = sel->route != 0u;
  const long long count = all ? n : static_cast<long long>(sel->mid);
  const int shift = 24 - 8 * pass;
  const unsigned int hm = digit_mask(pass);
  const unsigned int p0 = sel->key[0], p1 = sel->key[1];
  for (int i = threadIdx.x; i < 512; i += blockDim.x) h[i] = 0u;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x;
       i0 < count; i0 += stride) {
    const long long i = i0 + threadIdx.x;
    const bool ok = i < count;
    const unsigned int key = !ok ? 0u : all ? mag_key(spec[i]) : cand[i];
    const unsigned int d = (key >> shift) & 255u;
    hist_add(h, d, ok && need0 && (key & hm) == p0);
    hist_add(h, 256 + d, ok && need1 && (key & hm) == p1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 512; i += blockDim.x)
    if (h[i]) atomicAdd(&sel->hist[i], h[i]);
  if (!last_block(&sel->done)) return;
  volatile NotchSel* vs = sel;
  for (int i = threadIdx.x; i < 512; i += blockDim.x) h[i] = vs->hist[i];
  __syncthreads();
  if (threadIdx.x < 2 && (threadIdx.x ? need1 : need0)) {
    unsigned int key = vs->key[threadIdx.x], rank = vs->rank[threadIdx.x];
    radix_step(h + 256 * threadIdx.x, key, rank, shift);
    vs->key[threadIdx.x] = key;
    vs->rank[threadIdx.x] = rank;
  }
  for (int i = threadIdx.x; i < 512; i += blockDim.x) vs->hist[i] = 0u;
  if (threadIdx.x == 0) vs->done = 0u;
}

// Stage 4: thr = factor * ((a + b) * 0.5), a and b the two middle
// magnitudes (jnp.median's midpoint); a bin is kept where |X| <= thr.
template <bool kInPlace>
__global__ void __launch_bounds__(kThreads)
notch_kernel(const float2* spec, long long n, const NotchSel* sel,
             float factor, float2* out) {
  const float a = __uint_as_float(sel->key[0]);
  const float b = __uint_as_float(sel->key[1]);
  const float t = __fmul_rn(factor, __fmul_rn(__fadd_rn(a, b), 0.5f));
  // kUnroll loads in flight a thread, each coalesced across the block
  constexpr int kUnroll = 4;
  const long long step =
      static_cast<long long>(gridDim.x) * blockDim.x * kUnroll;
  for (long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x *
                          kUnroll + threadIdx.x;
       i0 < n; i0 += step) {
    float2 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * blockDim.x;
      v[u] = i < n ? spec[i] : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * blockDim.x;
      if (i >= n) break;
      const bool keep = sqrtf(power(v[u])) <= t;
      if (!kInPlace)
        out[i] = keep ? v[u] : make_float2(0.0f, 0.0f);
      else if (!keep)
        out[i] = make_float2(0.0f, 0.0f);
    }
  }
}

// ---------------------------------------------------------------- K7d ----

// mode 0 (Mmse_Resampler): position k*ratio in float64, linear
// interpolation a*(1-frac) + b*frac in float32 between floor(pos) and the
// next sample (clamped to the last); mode 1 (Direct_Resampler): the
// sample at min(floor(k*ratio), n_in-1).
__global__ void __launch_bounds__(kThreads)
resample_kernel(const float2* __restrict__ x, long long n_in, double ratio,
                int mode, float2* __restrict__ y, long long n_out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       k < n_out; k += stride) {
    const double pos = __dmul_rn(static_cast<double>(k), ratio);
    const double fl = floor(pos);
    const long long i0 = min(static_cast<long long>(fl), n_in - 1);
    if (mode == 1) {
      y[k] = x[i0];
      continue;
    }
    const float frac = __double2float_rn(__dsub_rn(pos, fl));
    const float w0 = __fsub_rn(1.0f, frac);
    const float2 a = x[i0];
    const float2 b = x[min(i0 + 1, n_in - 1)];
    y[k] = make_float2(__fadd_rn(__fmul_rn(a.x, w0), __fmul_rn(b.x, frac)),
                       __fadd_rn(__fmul_rn(a.y, w0), __fmul_rn(b.y, frac)));
  }
}

constexpr int kMaxAntennas = 32;

// One output sample of beamformer.py::beamform's four einsums: rr = sum_m
// x_re w_re, ii = sum_m x_im w_im, ri = sum_m x_re w_im, ir = sum_m x_im
// w_re, each a chain of fused multiply-adds over m in order, then
// y = (rr - ii, ri + ir).
struct Beam {
  float rr = 0.0f, ii = 0.0f, ri = 0.0f, ir = 0.0f;
  __device__ __forceinline__ void add(float xr, float xi, float wr,
                                      float wi) {
    rr = __fmaf_rn(xr, wr, rr);
    ii = __fmaf_rn(xi, wi, ii);
    ri = __fmaf_rn(xr, wi, ri);
    ir = __fmaf_rn(xi, wr, ir);
  }
  __device__ __forceinline__ float2 out() const {
    return make_float2(__fsub_rn(rr, ii), __fadd_rn(ri, ir));
  }
};

// A 16-byte read-only load that asks L2 to fetch the whole 256-byte
// block around it: K7e's rows are streamed once, in order.
__device__ __forceinline__ float4 load_stream4(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// y[k] = sum_m w_m x_m[k], y complex64. Antenna m's sample k is
// (x_re[m ld + k es], x_im[m ld + k es]) (floats); the weights are read
// from shared memory. kPairs: interleaved rows (x_im = x_re + 1, es = 2)
// with 16-byte aligned row starts and y: thread q takes the samples 2q,
// 2q + 1, one float4 load from each row, kLoadBatch rows' loads issued
// before their sums, and one float4 store, and thread n / 2 the odd last
// sample; else thread k takes sample k. One thread an item, no grid
// stride: a grid of whole waves striding over the samples came out
// slower.
constexpr int kLoadBatch = 8;

template <bool kPairs>
__global__ void __launch_bounds__(kThreads)
beamform_kernel(const float* __restrict__ x_re, const float* __restrict__ x_im,
                long long es, long long ld, int m_n, long long n,
                const float* __restrict__ w_re, const float* __restrict__ w_im,
                float2* __restrict__ y) {
  __shared__ float s_w[2 * kMaxAntennas];
  for (int i = threadIdx.x; i < m_n; i += blockDim.x) {
    s_w[i] = w_re[i];
    s_w[kMaxAntennas + i] = w_im[i];
  }
  __syncthreads();
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  auto sample = [&](long long k) {
    Beam b;
    for (int m = 0; m < m_n; ++m) {
      const long long at = m * ld + k * es;
      b.add(x_re[at], x_im[at], s_w[m], s_w[kMaxAntennas + m]);
    }
    y[k] = b.out();
  };
  if (!kPairs) {
    if (t < n) sample(t);
    return;
  }
  const long long pairs = n >> 1;
  if (t >= pairs) {
    if (t == pairs && (n & 1)) sample(n - 1);
    return;
  }
  Beam lo, hi;
  for (int m0 = 0; m0 < m_n; m0 += kLoadBatch) {
    float4 v[kLoadBatch];
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j)
      if (m0 + j < m_n) v[j] = load_stream4(x_re + (m0 + j) * ld + 4 * t);
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      if (m0 + j < m_n) {
        const float wr = s_w[m0 + j], wi = s_w[kMaxAntennas + m0 + j];
        lo.add(v[j].x, v[j].y, wr, wi);
        hi.add(v[j].z, v[j].w, wr, wi);
      }
    }
  }
  const float2 a = lo.out(), c = hi.out();
  reinterpret_cast<float4*>(y)[t] = make_float4(a.x, a.y, c.x, c.y);
}

template <bool kPairs>
void launch_beamform(const float* x_re, const float* x_im, long long es,
                     long long ld, int m_ant, long long n, const float* w_re,
                     const float* w_im, float2* y, cudaStream_t s) {
  const long long items = kPairs ? (n + 1) / 2 : n;
  const auto blocks =
      static_cast<unsigned int>((items + kThreads - 1) / kThreads);
  beamform_kernel<kPairs><<<blocks, kThreads, 0, s>>>(
      x_re, x_im, es, ld, m_ant, n, w_re, w_im, y);
}

// blocks for a grid-stride elementwise pass over n items
unsigned int stride_blocks(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(want < 132 * 32 ? (want > 0 ? want : 1)
                                                   : 132 * 32);
}

// K7a's tile: the taps and the D planes of q_pad + T inputs each.
int fir_q_pad(int n_taps, int decim) {
  const int r = fir_outputs(decim);
  return ((n_taps + decim - 1) / decim + r - 1) / r * r;
}

size_t fir_smem(int n_taps, int decim, int threads) {
  const int stride = fir_plane_stride(
      fir_q_pad(n_taps, decim) + threads * fir_outputs(decim),
      fir_outputs(decim));
  return sizeof(float) * ((n_taps + 1) & ~1) +
         2 * sizeof(float2) * static_cast<size_t>(decim) * stride;
}

struct FirLaunch {
  const float2* x;
  long long n_in;
  const float* taps;
  int n_taps, decim;
  double nco_step;
  long long n0;
  int q_pad;
  float2* y;
  long long n_out;
  long long tiles;
  int threads;
  size_t smem;
  cudaStream_t stream;
};

// Launch K7a, or with ``per_sm`` only report how many of its blocks an
// SM holds.
template <int kD, bool kTranslate>
int fir_launch_as(const FirLaunch& f, int* per_sm_out) {
  auto* kernel = fir_decim_kernel<kD, kTranslate>;
  // all of the SM's unified memory as shared memory: the persistent grid
  // below assumes as many blocks an SM as the occupancy query finds
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && f.smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(f.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent blocks: as many as the card holds at once
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, f.threads, f.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm_out) {
    *per_sm_out = per_sm;
    return 0;
  }
  const long long most = static_cast<long long>(sms) * per_sm;
  const auto blocks = static_cast<unsigned int>(
      f.tiles < most ? f.tiles : (most > 0 ? most : 1));
  kernel<<<blocks, f.threads, f.smem, f.stream>>>(
      f.x, f.n_in, f.taps, f.n_taps, f.decim, f.nco_step, f.n0, f.q_pad, f.y,
      f.n_out);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int fir_launch(const FirLaunch& f, int translate, int* per_sm) {
  return translate ? fir_launch_as<kD, true>(f, per_sm)
                   : fir_launch_as<kD, false>(f, per_sm);
}

// K7a's block: the most threads of 128, 64, 32 whose tile fits the card's
// opt-in shared memory a block, and that memory; false when none fits.
bool fir_plan(int n_taps, int decim, int& threads, size_t& smem) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return false;
  threads = kFirThreads;
  while (threads > 32 &&
         fir_smem(n_taps, decim, threads) > static_cast<size_t>(limit))
    threads /= 2;
  smem = fir_smem(n_taps, decim, threads);
  return smem <= static_cast<size_t>(limit);
}

int fir_dispatch(const FirLaunch& f, int translate, int* per_sm) {
  switch (f.decim) {
    case 1: return fir_launch<1>(f, translate, per_sm);
    case 2: return fir_launch<2>(f, translate, per_sm);
    case 3: return fir_launch<3>(f, translate, per_sm);
    case 4: return fir_launch<4>(f, translate, per_sm);
    default: return fir_launch<0>(f, translate, per_sm);
  }
}

// K7c: the sample ranks' margin around the targets' (about four standard
// deviations of a sample quantile's rank, sqrt(m) / 2 at the median),
// and the blocks of a select pass
constexpr long long kNotchMargin = 192;
constexpr unsigned int kSelectBlocks = 132 * 4;

}  // namespace

extern "C" {

// K7a. Its block: the most threads of 128, 64, 32 whose tile fits the
// card's shared memory a block (opt-in, 227 KB on the H100);
// cudaErrorInvalidValue when not even 32 fit (fir_decim_max_taps).
int fir_decim(const float* x, long long n_in, const float* taps, int n_taps,
              int decim, int translate, double nco_step, long long n0,
              float* y, long long n_out, void* stream) {
  int threads = 0;
  size_t smem = 0;
  if (n_taps < 1 || decim < 1 || n_out < 1 ||
      !fir_plan(n_taps, decim, threads, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tile = static_cast<long long>(threads) * fir_outputs(decim);
  const FirLaunch f{reinterpret_cast<const float2*>(x), n_in, taps, n_taps,
                    decim, nco_step, n0, fir_q_pad(n_taps, decim),
                    reinterpret_cast<float2*>(y), n_out,
                    (n_out + tile - 1) / tile, threads, smem,
                    static_cast<cudaStream_t>(stream)};
  return fir_dispatch(f, translate, nullptr);
}

// fir_decim's threads a block at (n_taps, decim, translate) and how many
// of its blocks an SM of the current card holds at once.
int fir_decim_occupancy(int n_taps, int decim, int translate, int* threads,
                        int* per_sm) {
  size_t smem = 0;
  if (n_taps < 1 || decim < 1 || !fir_plan(n_taps, decim, *threads, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const FirLaunch f{nullptr, 0, nullptr, n_taps, decim, 0.0, 0,
                    fir_q_pad(n_taps, decim), nullptr, 0, 0, *threads, smem,
                    nullptr};
  return fir_dispatch(f, translate, per_sm);
}

// The largest tap count fir_decim takes at ``decim`` on card ``device``
// (its tile at 32 threads within the opt-in shared memory a block);
// -1 when the attribute cannot be read.
int fir_decim_max_taps(int decim, int device) {
  int limit = 0;
  if (decim < 1 ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  int lo = 0, hi = 1 << 24;   // fir_smem(lo) fits, fir_smem(hi) does not
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    (fir_smem(mid, decim, 32) <= static_cast<size_t>(limit) ? lo : hi) = mid;
  }
  return lo;
}

// K7b. ``partials`` holds ``n_parts`` doubles, ``thr`` one float.
int pulse_blank(const float* x, long long n, float sigma2, double* partials,
                int n_parts, float* thr, float* y, void* stream) {
  if (n < 1 || n_parts < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xv = reinterpret_cast<const float2*>(x);
  power_partials_kernel<<<n_parts, kThreads, 0, s>>>(xv, n, partials);
  blank_threshold_kernel<<<1, kThreads, 0, s>>>(partials, n_parts, n, sigma2,
                                                thr);
  blank_kernel<<<stride_blocks(n), kThreads, 0, s>>>(
      xv, n, thr, reinterpret_cast<float2*>(y));
  return static_cast<int>(cudaGetLastError());
}

// K7c. ``sel`` holds notch_sel_words() uints, ``cand`` ``cap`` uints;
// k_lo and k_hi are the 0-based ranks of the two middle values. ``out``
// may be ``spec`` itself: then only the excised bins are written.
int notch_mask(const float* spec, long long n, float factor,
               unsigned int* sel, unsigned int* cand, unsigned int cap,
               float* out, unsigned int k_lo, unsigned int k_hi,
               void* stream) {
  if (n < 1 || n > 0xffffffffLL || k_hi >= n)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* sv = reinterpret_cast<const float2*>(spec);
  auto* st = reinterpret_cast<NotchSel*>(sel);
  const int m = static_cast<int>(n < kNotchSample ? n : kNotchSample);
  const auto rank = [&](unsigned int k, long long margin) {
    const long long r = static_cast<long long>(k) * m / n + margin;
    return static_cast<int>(r < -1 ? -1 : r > m ? m : r);
  };
  notch_sample_kernel<<<1, kNotchSampleThreads, 0, s>>>(
      sv, n, m, rank(k_lo, -kNotchMargin), rank(k_hi, kNotchMargin), st);
  notch_bracket_kernel<<<stride_blocks(n), kThreads, 0, s>>>(
      sv, n, cand, cap, k_lo, k_hi, st);
  for (int pass = 0; pass < 4; ++pass)
    notch_select_kernel<<<kSelectBlocks, kThreads, 0, s>>>(sv, n, cand, st,
                                                           pass);
  auto* ov = reinterpret_cast<float2*>(out);
  if (out == spec)
    notch_kernel<true><<<stride_blocks(n), kThreads, 0, s>>>(sv, n, st,
                                                             factor, ov);
  else
    notch_kernel<false><<<stride_blocks(n), kThreads, 0, s>>>(sv, n, st,
                                                              factor, ov);
  return static_cast<int>(cudaGetLastError());
}

int notch_sel_words() { return sizeof(NotchSel) / sizeof(unsigned int); }

int notch_sample_size() { return kNotchSample; }

// K7d. mode 0 Mmse_Resampler, mode 1 Direct_Resampler.
int resample(const float* x, long long n_in, double ratio, int mode,
             float* y, long long n_out, void* stream) {
  if (n_in < 1 || n_out < 1 || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  resample_kernel<<<stride_blocks(n_out), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(x), n_in, ratio, mode,
      reinterpret_cast<float2*>(y), n_out);
  return static_cast<int>(cudaGetLastError());
}

// K7e. The M antenna rows as float pointers x_re, x_im with element
// stride es and row stride ld (floats): contiguous planes (es = 1) or
// the two halves of interleaved complex64 rows (x_im = x_re + 1, es = 2);
// the weights w_re, w_im [M]; y complex64 [n].
int beamform(const float* x_re, const float* x_im, long long es,
             long long ld, int m_ant, long long n, const float* w_re,
             const float* w_im, float* y, void* stream) {
  if (m_ant < 1 || m_ant > kMaxAntennas || n < 1 || es < 1 || ld < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool pairs = x_im == x_re + 1 && es == 2 && ld % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(x_re) | reinterpret_cast<uintptr_t>(y)) &
       15) == 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto* yv = reinterpret_cast<float2*>(y);
  if (pairs)
    launch_beamform<true>(x_re, x_im, es, ld, m_ant, n, w_re, w_im, yv, s);
  else
    launch_beamform<false>(x_re, x_im, es, ld, m_ant, n, w_re, w_im, yv, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
