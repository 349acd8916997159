// Per-step noise of the simulator: out[i] = sigma * normal(seed, t, i) for
// the ids i < n, with the reference's keying and bits.
//
// Not a TPU kernel: the reference draws its noise as jnp outside Pallas,
// sigma * jax.random.normal(fold_in(PRNGKey(seed), t), (n,))
// (src/repro/snn/simulator.py:409-415).  This kernel reproduces it:
//   * the step key is fold_in((0, seed mod 2^32), t): the cipher applied to
//     the counter pair (0, t mod 2^32) -- derived here from (seed, t), once a
//     block (thread 0, through shared memory), so no generator state lives
//     on the host;
//   * the raw bits of id i are x0 ^ x1 of the cipher under the step key at
//     the counter pair (i >> 32, i & 0xffffffff), as jax's partitionable
//     threefry draws them;
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
// version (kernels/ref.py:step_noise_ref), so the two agree bit for bit and
// the noise is the same on the card and on the CPU.  The constants are
// written as the f32 roundings (hex) of the decimal coefficients there.
// Bound on the H100: it writes 4 bytes an id (0.31 MB at 77,172 ids) and
// runs one cipher and about 60 float operations an id: launch-bound at the
// simulator's sizes.  Design: one thread per id, a grid-stride loop.
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

__global__ void __launch_bounds__(kThreads)
    noise_kernel(float* __restrict__ out, int64_t n, uint32_t seed, uint32_t t,
                 float sigma) {
  // the step key, fold_in(PRNGKey(seed), t): one cipher a block
  __shared__ uint32_t key[2];
  if (threadIdx.x == 0) {
    threefry2x32_20(0u, seed, threefry_parity(0u, seed), 0u, t, key[0], key[1]);
  }
  __syncthreads();
  const uint32_t s0 = key[0], s1 = key[1];
  const uint32_t s2 = threefry_parity(s0, s1);
  const float lo = -0x1.fffffep-1f;  // nextafter(-1, 0)
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t o0, o1;
    threefry2x32_20(s0, s1, s2, static_cast<uint32_t>(i >> 32), static_cast<uint32_t>(i),
                    o0, o1);
    const uint32_t bits = o0 ^ o1;
    const float f = __int_as_float(static_cast<int>((bits >> 9) | 0x3F800000u));
    float u = __fadd_rn(__fmul_rn(__fsub_rn(f, 1.0f), 2.0f), lo);
    u = u < lo ? lo : u;
    const float z = __fmul_rn(0x1.6a09e6p+0f, erfinv_port(u));  // f32(sqrt(2))
    out[i] = __fmul_rn(sigma, z);
  }
}

}  // namespace

extern "C" int repro_noise(float* out, int64_t n, uint32_t seed, uint32_t t, float sigma,
                           void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  noise_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(out, n, seed, t, sigma);
  return cudaGetLastError();
}
