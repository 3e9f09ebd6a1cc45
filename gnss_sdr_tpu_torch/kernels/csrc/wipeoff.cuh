// K2a and K5a: the carrier wiped off at every Doppler bin and the buffer
// folded over its S segments, one templated body for both.
//
// Replaces the wipe-off of gnss_sdr_tpu/acquisition/pcps.py:175-180
// (_pcps_magnitude_grid; acq.cu's acq_wipeoff, S = 1) and the prologue
// of gnss_sdr_tpu/acquisition/variants.py:42-47 (_folded_grid;
// acq_variants.cu's fold_wipeoff, S >= 1). For every bin d and folded
// index m < NF = N / S:
//   out[d, m] = sum_{s < S} x[n] e^{j fl(fl(c0 f_d) n)},  n = s NF + m,
// the segments summed in order, every product and sum rounded as the
// plain versions round it (no contraction), the sin/cos the accurate
// sincosf of the same float32 phase (phases reach ~125 rad at E1's 4 ms;
// no __sinf, no recurrence), so the output equals the plain version's
// arithmetic to the bit up to the two libraries' sincos.
//
// Bound (H100): K2a writes D x N x 8 bytes (E1: 10.24 MB, 3.1 us of
// bytes) and reads N x 8; K5a writes S times less. Each output costs S
// accurate sincosf (~32 SASS instructions on the fast path, each call
// fenced by its slow path's divergence region, so a thread's calls do not
// overlap). The small grids (L1, E5a, K5a) are bound by the launch (an
// empty kernel launched alike takes ~1 us) and one memory round trip;
// K2a at E1 by its stores; K5a by its chained sincosf calls above the
// launch. Design:
// - a 2-D grid with 32-bit indices, no integer divide: blockIdx.y is a
//   unit of bins, the x dimension the folded row's samples, 256 threads
//   a block;
// - a unit is bin u and its mirror D - u (units 0 and D / 2 hold one
//   bin): R = 2 bins a thread, x loaded once for both. Where the float32
//   grid holds a bin and its exact negation (pcps.py::doppler_grid:
//   -f_max ... f_max - step), fl(c0 f) and the phase are negated
//   exactly, so one sincosf serves both bins (cos even and sin odd in the
//   accurate routine, held to the bit on the card against one bin a
//   launch); any other pair takes its own sincosf. More units a thread (a
//   loop over units in fewer, larger blocks) raised the registers a
//   thread and lost at E1 and E5a;
// - a thread owns 2 consecutive outputs of its unit's rows (one 16-byte
//   load of x a segment, one 16-byte store a bin) when NF is even, x and
//   out are 16-byte aligned and the pairs still give
//   kWipePairThreadsPerSm threads an SM; else 1 output (kPairs false):
//   the small grids (L1: 21 units x 2000 pairs) need the threads to hide
//   the sincosf chains more than they need the wide stores;
// - c0 f_d of the unit's bins formed once a thread (__fmul_rn);
// - plain stores: the output is the next cuFFT's input and fits in L2.
#pragma once
#include "common.cuh"

namespace {

// The launch rule (wipeoff_shape): the threads a block, and the threads
// an SM below which a thread takes one output (not a pair) of its unit's
// rows.
constexpr int kWipeThreads = 256;
constexpr int kWipePairThreadsPerSm = 512;

struct WipeoffShape {
  dim3 grid;
  bool pairs;
};

// The launch of a wipe-off of D bins into rows of NF outputs on a card of
// ``sms`` SMs: a row of kWipeThreads-thread blocks a unit, one thread a
// pair of outputs when NF is even, x and out are 16-byte aligned
// (``aligned``) and the pairs still give kWipePairThreadsPerSm threads an
// SM (enough warps to hide the sincosf chains), else one output a thread.
inline WipeoffShape wipeoff_shape(bool aligned, int NF, int D, int sms) {
  const int units = D / 2 + 1;
  const bool pairs =
      aligned && NF % 2 == 0 &&
      static_cast<long long>(NF / 2) * units >=
          static_cast<long long>(kWipePairThreadsPerSm) * sms;
  const int per_row = pairs ? NF / 2 : NF;
  return {dim3((per_row + kWipeThreads - 1) / kWipeThreads, units), pairs};
}

// The current card's SM count (read once).
inline int wipeoff_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 132;
  }
  return sms;
}

// acc (+)= v e^{j ph} as the plain version rounds it; the first segment
// assigns.
__device__ __forceinline__ void rotate_into(float& re, float& im, float2 v,
                                            float cs, float sn, bool first) {
  const float r = __fsub_rn(__fmul_rn(v.x, cs), __fmul_rn(v.y, sn));
  const float i = __fadd_rn(__fmul_rn(v.x, sn), __fmul_rn(v.y, cs));
  re = first ? r : __fadd_rn(re, r);
  im = first ? i : __fadd_rn(im, i);
}

// kS > 0: S = kS segments, unrolled; kS = 0: S from the argument.
template <int kS, bool kPairs>
__global__ void __launch_bounds__(kWipeThreads)
wipeoff_fold_kernel(const float2* __restrict__ x,
                    const float* __restrict__ dopplers, float c0, int S,
                    int NF, int D, float2* __restrict__ out) {
  constexpr int kW = kPairs ? 2 : 1;  // outputs a thread and bin
  const int i = blockIdx.x * kWipeThreads + threadIdx.x;
  if (i >= (kPairs ? NF >> 1 : NF)) return;
  const int m = i * kW;
  const int u = blockIdx.y;
  const int v = D - u;
  const bool two = u > 0 && v > u;
  const float f0 = dopplers[u];
  const float w0 = __fmul_rn(c0, f0);
  float w1 = 0.0f;
  bool mirror = false;
  if (two) {
    const float f1 = dopplers[v];
    w1 = __fmul_rn(c0, f1);
    mirror = __float_as_uint(f1) == (__float_as_uint(f0) ^ 0x80000000u);
  }
  float re0[kW] = {}, im0[kW] = {}, re1[kW] = {}, im1[kW] = {};
  const int segs = kS > 0 ? kS : S;
#pragma unroll
  for (int s = 0; s < segs; ++s) {
    const int n0 = s * NF + m;
    float2 xv[kW];
    if (kPairs) {
      const float4 p = *reinterpret_cast<const float4*>(x + n0);
      xv[0] = make_float2(p.x, p.y);
      xv[kW - 1] = make_float2(p.z, p.w);
    } else {
      xv[0] = x[n0];
    }
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const float n = static_cast<float>(n0 + k);
      float sn, cs;
      sincosf(__fmul_rn(w0, n), &sn, &cs);
      rotate_into(re0[k], im0[k], xv[k], cs, sn, s == 0);
      if (two) {
        if (mirror)
          sn = -sn;
        else
          sincosf(__fmul_rn(w1, n), &sn, &cs);
        rotate_into(re1[k], im1[k], xv[k], cs, sn, s == 0);
      }
    }
  }
  float2* o0 = out + static_cast<size_t>(u) * NF + m;
  float2* o1 = out + static_cast<size_t>(v) * NF + m;
  if (kPairs) {
    *reinterpret_cast<float4*>(o0) =
        make_float4(re0[0], im0[0], re0[kW - 1], im0[kW - 1]);
    if (two)
      *reinterpret_cast<float4*>(o1) =
          make_float4(re1[0], im1[0], re1[kW - 1], im1[kW - 1]);
  } else {
    *o0 = make_float2(re0[0], im0[0]);
    if (two) *o1 = make_float2(re1[0], im1[0]);
  }
}

// wipeoff_fold_kernel<kS, *> on the launch wipeoff_shape gives.
template <int kS>
int wipeoff_fold_launch(const float* x, const float* dopplers, float c0,
                        int S, int NF, int D, float* out, void* stream) {
  if (NF < 1 || D < 1 || S < 1 || D / 2 + 1 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const WipeoffShape L = wipeoff_shape(
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0,
      NF, D, wipeoff_sms());
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xv = reinterpret_cast<const float2*>(x);
  auto* ov = reinterpret_cast<float2*>(out);
  if (L.pairs)
    wipeoff_fold_kernel<kS, true><<<L.grid, kWipeThreads, 0, st>>>(
        xv, dopplers, c0, S, NF, D, ov);
  else
    wipeoff_fold_kernel<kS, false><<<L.grid, kWipeThreads, 0, st>>>(
        xv, dopplers, c0, S, NF, D, ov);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
