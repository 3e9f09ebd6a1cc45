// K7: the signal conditioner's device programs (sm_90a).
//
// Replaces the jitted programs of gnss_sdr_tpu/conditioner/:
//   K7a fir.py::fir_filter, fir.py::freq_xlating_fir_filter and the
//       translation NCO of chain.py::SignalConditionerChain._apply_planar
//       (fir_decim_kernel);
//   K7b interference.py::pulse_blanking (power_partials_kernel,
//       blank_threshold_kernel, blank_kernel);
//   K7c interference.py::notch_filter_block, the part around the two FFTs
//       (magnitude_kernel, the radix select, notch_threshold_kernel,
//       notch_kernel); the FFTs stay on cuFFT (torch.fft);
//   K7d resampler.py::mmse_resample and the Direct_Resampler gather of
//       chain.py (resample_kernel);
//   K7e beamformer.py::beamform, the antenna-array combiner of
//       BeamformerFilter (beamform_kernel): y = sum_m w_m x_m over the
//       M antenna channels, as JAX's four einsums then their difference
//       and sum.
//
// All samples are interleaved complex64 (float2). Every pass reads each
// input once and writes each output once, so all four are bound by HBM
// bytes at the conditioner's shapes (tens of millions of samples):
//   K7a computes only the kept (every D-th) outputs from a shared-memory
//       tile of translated inputs: each input sample is loaded and
//       translated once per tile (the ntaps-1 halo between tiles is the
//       only repeat), and no cos/sin table exists in device memory.
//   K7b reduces the block's mean power in float64 in two fixed-order
//       passes (block partials, then one block over the partials): no
//       float atomics, so the threshold is the same on every run.
//   K7c finds the two middle order statistics of |X| by a radix select
//       on the float bit patterns (four 8-bit passes of shared-memory
//       histograms with integer atomics), then masks.
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

// e^{j phi} of the translation NCO at absolute input index n, with
// phi = mod(step * n, 2 pi) in float64 (np.mod semantics: result in
// [0, 2 pi)), rounded to float32 after cos/sin.
__device__ __forceinline__ void nco(double step, long long n, float& c,
                                    float& s) {
  double r = fmod(__dmul_rn(step, static_cast<double>(n)), kTwoPi);
  if (r < 0.0) r = __dadd_rn(r, kTwoPi);
  double sd, cd;
  sincos(r, &sd, &cd);
  c = __double2float_rn(cd);
  s = __double2float_rn(sd);
}

// y[k] = sum_j taps[j] * x'[k*decim - j] for k < n_out, x'[n] = 0 for
// n < 0 and x'[n] = x[n] e^{j phi(n0 + n)} (or x[n] without translation).
// Block b owns outputs [b*tile_out, (b+1)*tile_out) and stages the
// translated inputs they read, (tile_out-1)*decim + n_taps samples, in
// shared memory behind the taps.
template <bool kTranslate>
__global__ void __launch_bounds__(kThreads)
fir_decim_kernel(const float2* __restrict__ x, long long n_in,
                 const float* __restrict__ taps, int n_taps, int decim,
                 double nco_step, long long n0, int tile_out,
                 float2* __restrict__ y, long long n_out) {
  extern __shared__ float smem[];
  float* s_taps = smem;
  float2* s_x = reinterpret_cast<float2*>(smem + ((n_taps + 1) & ~1));
  const long long k0 = static_cast<long long>(blockIdx.x) * tile_out;
  const long long first = k0 * decim - (n_taps - 1);
  const int span = (tile_out - 1) * decim + n_taps;
  for (int i = threadIdx.x; i < n_taps; i += blockDim.x) s_taps[i] = taps[i];
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const long long n = first + i;
    float2 v = make_float2(0.0f, 0.0f);
    if (n >= 0 && n < n_in) {
      v = x[n];
      if (kTranslate) {
        float c, s;
        nco(nco_step, n0 + n, c, s);
        v = make_float2(__fsub_rn(__fmul_rn(v.x, c), __fmul_rn(v.y, s)),
                        __fadd_rn(__fmul_rn(v.x, s), __fmul_rn(v.y, c)));
      }
    }
    s_x[i] = v;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < tile_out; t += blockDim.x) {
    const long long k = k0 + t;
    if (k >= n_out) break;
    // w[0] is x'[k*decim]; tap j reads w[-j]
    const float2* w = s_x + t * decim + (n_taps - 1);
    float ar = 0.0f, ai = 0.0f;
    for (int j = 0; j < n_taps; ++j) {
      const float2 v = w[-j];
      const float tj = s_taps[j];
      ar = __fadd_rn(ar, __fmul_rn(v.x, tj));
      ai = __fadd_rn(ai, __fmul_rn(v.y, tj));
    }
    y[k] = make_float2(ar, ai);
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

// sel layout: [0] prefix of target 0, [1] prefix of target 1, [2] rank of
// target 0 inside its prefix, [3] rank of target 1; [4 .. 4+512) the two
// 256-bin histograms of the current pass.
constexpr int kSelHist = 4;

__global__ void __launch_bounds__(kThreads)
magnitude_kernel(const float2* __restrict__ spec, long long n,
                 float* __restrict__ mag) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    mag[i] = sqrtf(power(spec[i]));
}

__global__ void select_init_kernel(unsigned int* __restrict__ sel,
                                   unsigned int k_lo, unsigned int k_hi) {
  if (threadIdx.x == 0) {
    sel[0] = 0u;
    sel[1] = 0u;
    sel[2] = k_lo;
    sel[3] = k_hi;
  }
  for (int i = threadIdx.x; i < 512; i += blockDim.x) sel[kSelHist + i] = 0u;
}

// Histogram of the 8-bit digit at ``shift`` over the keys whose bits above
// the digit equal each target's prefix (``hi_mask`` selects those bits).
// Magnitudes are non-negative, so their bit patterns order as the floats.
__global__ void __launch_bounds__(kThreads)
select_hist_kernel(const unsigned int* __restrict__ keys, long long n,
                   unsigned int* __restrict__ sel, int shift,
                   unsigned int hi_mask) {
  __shared__ unsigned int h[512];
  for (int i = threadIdx.x; i < 512; i += blockDim.x) h[i] = 0u;
  __syncthreads();
  const unsigned int p0 = sel[0], p1 = sel[1];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const unsigned int key = keys[i];
    const unsigned int digit = (key >> shift) & 255u;
    const unsigned int hi = key & hi_mask;
    if (hi == p0) atomicAdd(&h[digit], 1u);
    if (hi == p1) atomicAdd(&h[256 + digit], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 512; i += blockDim.x)
    if (h[i]) atomicAdd(&sel[kSelHist + i], h[i]);
}

// For each target: the digit whose bin holds its rank; extend the prefix,
// make the rank relative to that bin, clear the histograms.
__global__ void select_step_kernel(unsigned int* __restrict__ sel,
                                   int shift) {
  if (threadIdx.x < 2) {
    const int t = threadIdx.x;
    const unsigned int* h = sel + kSelHist + 256 * t;
    unsigned int rank = sel[2 + t], below = 0u;
    int d = 0;
    for (; d < 255; ++d) {
      if (below + h[d] > rank) break;
      below += h[d];
    }
    sel[t] |= static_cast<unsigned int>(d) << shift;
    sel[2 + t] = rank - below;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 512; i += blockDim.x) sel[kSelHist + i] = 0u;
}

// thr = factor * ((a + b) * 0.5) with a, b the two selected magnitudes
// (jnp.median's midpoint)
__global__ void notch_threshold_kernel(const unsigned int* __restrict__ sel,
                                       float factor,
                                       float* __restrict__ thr) {
  const float a = __uint_as_float(sel[0]);
  const float b = __uint_as_float(sel[1]);
  *thr = __fmul_rn(factor, __fmul_rn(__fadd_rn(a, b), 0.5f));
}

__global__ void __launch_bounds__(kThreads)
notch_kernel(const float2* __restrict__ spec, const float* __restrict__ mag,
             long long n, const float* __restrict__ thr,
             float2* __restrict__ out) {
  const float t = *thr;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    out[i] = mag[i] <= t ? spec[i] : make_float2(0.0f, 0.0f);
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

}  // namespace

extern "C" {

// K7a. Returns cudaErrorInvalidValue when the tile of one block does not
// fit in 48 KB of shared memory (more than ~6000 taps).
int fir_decim(const float* x, long long n_in, const float* taps, int n_taps,
              int decim, int translate, double nco_step, long long n0,
              float* y, long long n_out, void* stream) {
  if (n_taps < 1 || decim < 1 || n_out < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int tile_out = 1024;
  auto smem_bytes = [&](int tile) {
    return sizeof(float) * ((n_taps + 1) & ~1) +
           sizeof(float2) * (static_cast<size_t>(tile - 1) * decim + n_taps);
  };
  while (tile_out > 32 && smem_bytes(tile_out) > 48 * 1024) tile_out /= 2;
  if (smem_bytes(tile_out) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n_out + tile_out - 1) / tile_out;
  const dim3 grid(static_cast<unsigned int>(blocks)), block(kThreads);
  const size_t smem = smem_bytes(tile_out);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xv = reinterpret_cast<const float2*>(x);
  auto* yv = reinterpret_cast<float2*>(y);
  if (translate)
    fir_decim_kernel<true><<<grid, block, smem, s>>>(
        xv, n_in, taps, n_taps, decim, nco_step, n0, tile_out, yv, n_out);
  else
    fir_decim_kernel<false><<<grid, block, smem, s>>>(
        xv, n_in, taps, n_taps, decim, nco_step, n0, tile_out, yv, n_out);
  return static_cast<int>(cudaGetLastError());
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

// K7c. ``mag`` holds n floats, ``sel`` 4 + 512 uints, ``thr`` one float;
// k_lo and k_hi are the 0-based ranks of the two middle values.
int notch_mask(const float* spec, long long n, float factor, float* mag,
               unsigned int* sel, float* thr, float* out, unsigned int k_lo,
               unsigned int k_hi, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* sv = reinterpret_cast<const float2*>(spec);
  const unsigned int blocks = stride_blocks(n);
  magnitude_kernel<<<blocks, kThreads, 0, s>>>(sv, n, mag);
  select_init_kernel<<<1, kThreads, 0, s>>>(sel, k_lo, k_hi);
  const auto* keys = reinterpret_cast<const unsigned int*>(mag);
  const unsigned int masks[4] = {0x00000000u, 0xFF000000u, 0xFFFF0000u,
                                 0xFFFFFF00u};
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    select_hist_kernel<<<blocks, kThreads, 0, s>>>(keys, n, sel, shift,
                                                   masks[pass]);
    select_step_kernel<<<1, kThreads, 0, s>>>(sel, shift);
  }
  notch_threshold_kernel<<<1, 1, 0, s>>>(sel, factor, thr);
  notch_kernel<<<blocks, kThreads, 0, s>>>(sv, mag, n, thr,
                                           reinterpret_cast<float2*>(out));
  return static_cast<int>(cudaGetLastError());
}

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
