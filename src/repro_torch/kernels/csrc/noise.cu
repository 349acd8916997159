// Per-step noise of the simulator, with the reference's keying and bits:
// noise_add_kernel computes out[r] = (x[r] + sigma * normal(seed, t, ids[r]))
// [+ bias[r * bias_stride]], a partition's own ids drawn and added to its
// delivered ring slot (and bias) in one pass.  The whole (n,) vector of a
// step is the same launch at the ids 0..n-1 added to x = -0.0, which leaves
// every value as it is (kernels/noise.py:noise_cuda).
//
// Not a TPU kernel: the reference draws its noise as jnp outside Pallas,
// sigma * jax.random.normal(fold_in(PRNGKey(seed), t), (n,)), takes each
// partition's ids from it and adds i_syn + noise + bias, left to right
// (src/repro/snn/simulator.py:409-438).  The kernel reproduces it:
//   * the step key is fold_in((0, seed mod 2^32), t): the cipher applied to
//     the counter pair (0, t mod 2^32) -- derived here from (seed, t), once a
//     block (thread 0, through shared memory), so no generator state lives
//     on the host;
//   * the raw bits of id i are x0 ^ x1 of the cipher under the step key at
//     the counter pair (i >> 32, i & 0xffffffff), as jax's partitionable
//     threefry draws them; so an id's draw does not depend on which other
//     ids a launch draws;
//   * the uniform is jax.random.uniform's over [nextafter(-1, 0), 1): the
//     top 23 bits as a mantissa of [1, 2), minus 1, times 2, plus the lower
//     end, then max with it;
//   * the normal is sqrt(2) * erfinv(u) with Giles' single-precision erfinv
//     (the coefficients XLA uses), whose log1p is the port's own: log1p(v) =
//     log(1 + v) * (v / ((1 + v) - 1)), and log is Cephes' logf (exponent
//     extraction plus a fixed polynomial).
// The bits and uniforms equal jax's bit for bit; the normals differ from
// XLA's (its own log1p, and contracted multiply-adds) by up to 4.8e-7
// (tests/test_torch_noise.py).  Every float operation is one correctly
// rounded add, sub, mul, div or sqrt (_rn intrinsics; the library is built
// with --fmad=false), compare or select, in the order of the plain torch
// versions (kernels/ref.py:step_noise_ref, step_noise_add_ref), so the two
// agree bit for bit and the noise is the same on the card and on the CPU.
// The constants are written as the f32 roundings (hex) of the decimal
// coefficients there.
// Bound on the H100: one cipher and about 60 float operations an id, and 20
// bytes moved an id (x, the id, the bias read, the sum written): at the
// simulator's 77,172 ids well under a microsecond, so it is launch-bound.
// The engines' gain is in launches: it replaces the chain clone,
// full-vector draw, index_select, add and bias add with one launch.
// Design: one thread per id, a grid-stride loop.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 65535;

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

// The step key, fold_in(PRNGKey(seed), t): one cipher a block, by thread 0.
__device__ __forceinline__ void step_key(uint32_t seed, uint32_t t, const ThreefryMul& mul,
                                         uint32_t& s0, uint32_t& s1) {
  __shared__ uint32_t key[2];
  if (threadIdx.x == 0) {
    threefry2x32_20(0u, seed, threefry_parity(0u, seed), 0u, t, mul, key[0], key[1]);
  }
  __syncthreads();
  s0 = key[0];
  s1 = key[1];
}

// bias == nullptr: no bias (the unfused engine adds it in its neuron step).
__global__ void __launch_bounds__(kThreads)
    noise_add_kernel(const float* __restrict__ x, const int64_t* __restrict__ ids,
                     const float* __restrict__ bias, int64_t bias_stride,
                     float* __restrict__ out, int64_t n, uint32_t seed, uint32_t t,
                     float sigma, ThreefryMul mul) {
  uint32_t s0, s1;
  step_key(seed, t, mul, s0, s1);
  const uint32_t s2 = threefry_parity(s0, s1);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint64_t id = static_cast<uint64_t>(ids[i]);
    float v = __fadd_rn(x[i], scaled_normal(s0, s1, s2, static_cast<uint32_t>(id >> 32),
                                            static_cast<uint32_t>(id), sigma, mul));
    if (bias != nullptr) v = __fadd_rn(v, bias[i * bias_stride]);
    out[i] = v;
  }
}

int64_t grid_blocks(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

}  // namespace

// x, ids, out: (n,) contiguous; bias: element r at bias[r * bias_stride], or
// null.
extern "C" int repro_noise_add(const float* x, const int64_t* ids, const float* bias,
                               int64_t bias_stride, float* out, int64_t n, uint32_t seed,
                               uint32_t t, float sigma, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  noise_add_kernel<<<static_cast<unsigned>(grid_blocks(n)), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      x, ids, bias, bias_stride, out, n, seed, t, sigma, threefry_mul());
  return cudaGetLastError();
}
