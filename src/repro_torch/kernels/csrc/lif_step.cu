// LIF advance, one thread per neuron.
//
// Replaces: src/repro/kernels/lif_step.py:lif_step_pallas (pallas_call at
// :38), which tiles the state vectors into (rows, 128) VMEM panels.
// Bound on the H100: HBM bytes.  It reads v, refrac, i_syn and writes v',
// refrac', spike: 24 bytes a neuron and a handful of flops, far below the
// card's ridge point.  Design: one thread per neuron, consecutive threads on
// consecutive addresses (coalesced 128-byte warp transactions), no shared
// memory, no padding (the grid masks the ragged end instead of padding to a
// lane multiple).  At a microcircuit's 77K neurons the 1.85 MB moved take
// well under a microsecond of HBM time, so the launch itself dominates.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    lif_step_kernel(const float* __restrict__ v,
                    const float* __restrict__ refrac,
                    const float* __restrict__ i_syn, float* __restrict__ v_out,
                    float* __restrict__ r_out, float* __restrict__ s_out,
                    int n, LifParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    lif_advance(v[i], refrac[i], i_syn[i], p, v_out[i], r_out[i], s_out[i]);
  }
}

}  // namespace

extern "C" int repro_lif_step(const float* v, const float* refrac,
                              const float* i_syn, float* v_out, float* r_out,
                              float* s_out, int n, float v_rest, float v_reset,
                              float v_thresh, float decay,
                              float one_minus_decay, float r_m,
                              float ref_steps, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const LifParams p = make_lif_params(v_rest, v_reset, v_thresh, decay,
                                      one_minus_decay, r_m, ref_steps);
  const int blocks = (n + kThreads - 1) / kThreads;
  lif_step_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v, refrac, i_syn, v_out, r_out, s_out, n, p);
  return cudaGetLastError();
}
