// The simulator's per-step noise as device routines, shared by noise.cu
// (noise_add_kernel: the noise added to a ring slot, or the whole vector of a
// step) and step_front.cu (the step front, which draws it in the same
// launch as the LIF advance).  One copy of the arithmetic, so both kernels
// give the same bits; noise.cu's header comment says how each routine
// reproduces the reference's keying, bits, uniforms and normals, and why
// every float operation is a correctly rounded _rn intrinsic.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

// Cephes' logf for a normal y > 0: y = m * 2^e with m in [sqrt(1/2),
// sqrt(2)), log(y) = e * ln2 + log(m), ln2 split in two parts.
__device__ __forceinline__ float cephes_log(float y) {
  constexpr float kLogP[9] = {0x1.204376p-4f, -0x1.d7a37p-4f, 0x1.de4a34p-4f,
                              -0x1.fcba9ep-4f, 0x1.23d37ep-3f, -0x1.555cap-3f,
                              0x1.999d58p-3f, -0x1.fffff8p-3f, 0x1.555554p-2f};
  const int yb = __float_as_int(y);
  int e = (yb >> 23) - 126;
  const float m = __int_as_float((yb & 0x807FFFFF) | 0x3F000000);  // [0.5, 1)
  const bool small = m < 0x1.6a09e6p-1f;  // sqrt(1/2)
  if (small) e -= 1;
  const float ef = __int2float_rn(e);
  const float x = small ? __fsub_rn(__fadd_rn(m, m), 1.0f) : __fsub_rn(m, 1.0f);
  const float z = __fmul_rn(x, x);
  float p = kLogP[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fadd_rn(__fmul_rn(p, x), kLogP[i]);
  float r = __fmul_rn(__fmul_rn(x, z), p);
  r = __fadd_rn(r, __fmul_rn(ef, -0x1.bd0106p-13f));  // ln2 - 0.693359375
  r = __fadd_rn(r, __fmul_rn(z, -0.5f));
  const float s = __fadd_rn(x, r);
  return __fadd_rn(s, __fmul_rn(ef, 0x1.63p-1f));  // 0.693359375
}

// log1p(v) for v in (-1, 0]: exact where 1 + v rounds to 1, else log(1 + v)
// scaled by v over the exact (1 + v) - 1.
__device__ __forceinline__ float log1p_port(float v) {
  const float y = __fadd_rn(v, 1.0f);
  const float d = __fsub_rn(y, 1.0f);
  return d == 0.0f ? v : __fmul_rn(cephes_log(y), __fdiv_rn(v, d));
}

// Giles' single-precision erfinv, as XLA expands it: the two branches'
// coefficients selected per element, Horner with a separate multiply and add.
__device__ __forceinline__ float erfinv_port(float x) {
  constexpr float kA[9] = {0x1.e2cb1p-26f, 0x1.70966cp-22f, -0x1.d8e6aep-19f,
                           -0x1.26b582p-18f, 0x1.ca65b6p-13f, -0x1.48a81p-10f,
                           -0x1.11c9dep-8f, 0x1.f91ec6p-3f, 0x1.805c5ep+0f};
  constexpr float kB[9] = {-0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f,
                           -0x1.e17bcep-9f, 0x1.7824f6p-8f, -0x1.f38baep-8f,
                           0x1.354afcp-7f, 0x1.006db6p+0f, 0x1.6a9efcp+1f};
  const float t = __fmul_rn(x, x);
  float w = -log1p_port(-t);
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? kA[0] : kB[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fadd_rn(lt ? kA[i] : kB[i], __fmul_rn(p, w));
  return __fmul_rn(p, x);
}

// sigma times the normal of the raw bits of counter pair (hi, lo) under the
// step key (s0, s1, s2).
__device__ __forceinline__ float scaled_normal(uint32_t s0, uint32_t s1, uint32_t s2,
                                               uint32_t hi, uint32_t lo, float sigma,
                                               const ThreefryMul& mul) {
  uint32_t o0, o1;
  threefry2x32_20(s0, s1, s2, hi, lo, mul, o0, o1);
  const uint32_t bits = o0 ^ o1;
  const float lo_u = -0x1.fffffep-1f;  // nextafter(-1, 0)
  const float f = __int_as_float(static_cast<int>((bits >> 9) | 0x3F800000u));
  float u = __fadd_rn(__fmul_rn(__fsub_rn(f, 1.0f), 2.0f), lo_u);
  u = u < lo_u ? lo_u : u;
  const float z = __fmul_rn(0x1.6a09e6p+0f, erfinv_port(u));  // f32(sqrt(2))
  return __fmul_rn(sigma, z);
}

// The step key, fold_in(PRNGKey(seed), t): one cipher a block, by thread 0,
// which reads the step t from device memory (the simulator's carry holds it
// there, so one captured launch serves every step) and folds in its low 32
// bits, t mod 2^32 as the reference's uint32 fold_in takes it.
__device__ __forceinline__ void step_key(uint32_t seed, const int64_t* t, const ThreefryMul& mul,
                                         uint32_t& s0, uint32_t& s1) {
  __shared__ uint32_t key[2];
  if (threadIdx.x == 0) {
    threefry2x32_20(0u, seed, threefry_parity(0u, seed), 0u, static_cast<uint32_t>(*t), mul,
                    key[0], key[1]);
  }
  __syncthreads();
  s0 = key[0];
  s1 = key[1];
}
