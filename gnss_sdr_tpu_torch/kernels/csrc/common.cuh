// Shared helpers of the receiver's hand kernels (sm_90a).
//
// Rounding is made explicit with the __f*_rn intrinsics wherever the
// plain PyTorch version computes a product and a sum as two roundings:
// nvcc would otherwise contract them into one fused multiply-add, which
// moves a code-chip index or a carrier phase by one ulp at the edges.
// sincosf is the accurate library routine (never __sinf/__cosf and never
// --use_fast_math): carrier phases reach tens of radians before they are
// rotated.
#pragma once
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

template <typename T>
__device__ __forceinline__ float to_f32(T v) { return static_cast<float>(v); }

// Sum N per-thread values over the whole block; the result is valid in
// thread 0. ``scratch`` holds at least N * 32 floats.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = v[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) scratch[i * 32 + warp] = x;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float x = lane < n_warps ? scratch[i * 32 + lane] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x += __shfl_down_sync(0xffffffffu, x, off);
      v[i] = x;
    }
  }
}

// x * (c - j s): the rotation of derotate by a phase's cosine and sine.
__device__ __forceinline__ void rotate(float xr, float xi, float s, float c,
                                       float& out_re, float& out_im) {
  out_re = __fadd_rn(__fmul_rn(xr, c), __fmul_rn(xi, s));
  out_im = __fsub_rn(__fmul_rn(xi, c), __fmul_rn(xr, s));
}

// x * e^{-j phase}: the carrier wipe-off of the tracking correlators.
__device__ __forceinline__ void derotate(float xr, float xi, float phase,
                                         float& out_re, float& out_im) {
  float s, c;
  sincosf(phase, &s, &c);
  rotate(xr, xi, s, c, out_re, out_im);
}

// (value, index) max with the first index winning ties (jnp.argmax's rule)
__device__ __forceinline__ void take_max(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ inline void block_argmax(float& v, int& i, float* sv, int* si) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_down_sync(0xffffffffu, v, off);
    const int i2 = __shfl_down_sync(0xffffffffu, i, off);
    take_max(v, i, v2, i2);
  }
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < n_warps ? sv[lane] : -CUDART_INF_F;
    i = lane < n_warps ? si[lane] : 0x7fffffff;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_down_sync(0xffffffffu, v, off);
      const int i2 = __shfl_down_sync(0xffffffffu, i, off);
      take_max(v, i, v2, i2);
    }
  }
}
