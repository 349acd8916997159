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
//     on the host.  t is read from device memory (a 0-d int64 tensor, the
//     simulator's carry), so a captured launch draws the noise of whatever
//     step the carry holds when its graph replays;
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
// Design: one thread per id, a grid-stride loop.  The routines live in
// noise.cuh, shared with step_front.cu, which draws the same noise in the
// launch that advances the neurons.
#include <cuda_runtime.h>
#include <stdint.h>

#include "noise.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 65535;

// bias == nullptr: no bias (the unfused engine adds it in its neuron step).
__global__ void __launch_bounds__(kThreads)
    noise_add_kernel(const float* __restrict__ x, const int64_t* __restrict__ ids,
                     const float* __restrict__ bias, int64_t bias_stride,
                     float* __restrict__ out, int64_t n, uint32_t seed,
                     const int64_t* __restrict__ t, float sigma, ThreefryMul mul) {
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
// null; t: the step, one int64 in device memory.
extern "C" int repro_noise_add(const float* x, const int64_t* ids, const float* bias,
                               int64_t bias_stride, float* out, int64_t n, uint32_t seed,
                               const int64_t* t, float sigma, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  noise_add_kernel<<<static_cast<unsigned>(grid_blocks(n)), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      x, ids, bias, bias_stride, out, n, seed, t, sigma, threefry_mul());
  return cudaGetLastError();
}
