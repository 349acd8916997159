// Pre-exchange half of the plastic split step: LIF advance, spike emission
// and both e-trace decays, one thread per neuron.
//
// Replaces: src/repro/kernels/fused_step.py:fused_pre_exchange_pallas
// (pallas_call at :450), trace variant (body _make_pre_kernel:418).  The
// trace-free variant is lif_step.cu, as in the reference, where
// fused_pre_exchange without traces is lif_step_pallas.
// Bound on the H100: HBM bytes.  It reads v, refrac, i_tot and both traces
// and writes v', refrac', the spike and both traces: 40 bytes a neuron and
// about 14 flops, far below the card's ridge point.  Design: one thread per
// neuron, consecutive threads on consecutive addresses, no shared memory;
// the arithmetic is lif_advance and trace_decay of common.cuh, the routines
// of fused_plastic_step.cu's first phase, so the split engine's state and
// traces are bit-identical to the k=1 plastic engines'.  At a partition of a
// few thousand neurons the launch itself dominates.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    pre_exchange_kernel(const float* __restrict__ v,
                        const float* __restrict__ refrac,
                        const float* __restrict__ i_tot,
                        const float* __restrict__ tp,
                        const float* __restrict__ tm, float* __restrict__ v_out,
                        float* __restrict__ r_out, float* __restrict__ s_out,
                        float* __restrict__ tp_out, float* __restrict__ tm_out,
                        int n, LifParams p, float decay_plus,
                        float decay_minus) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    float s;
    lif_advance(v[i], refrac[i], i_tot[i], p, v_out[i], r_out[i], s);
    s_out[i] = s;
    tp_out[i] = trace_decay(tp[i], s, decay_plus);
    tm_out[i] = trace_decay(tm[i], s, decay_minus);
  }
}

}  // namespace

extern "C" int repro_pre_exchange(const float* v, const float* refrac,
                                  const float* i_tot, const float* tp,
                                  const float* tm, float* v_out, float* r_out,
                                  float* s_out, float* tp_out, float* tm_out,
                                  int n, float v_rest, float v_reset,
                                  float v_thresh, float decay,
                                  float one_minus_decay, float r_m,
                                  float ref_steps, float decay_plus,
                                  float decay_minus, void* stream,
                                  int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const LifParams p = make_lif_params(v_rest, v_reset, v_thresh, decay,
                                      one_minus_decay, r_m, ref_steps);
  const int blocks = (n + kThreads - 1) / kThreads;
  pre_exchange_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      v, refrac, i_tot, tp, tm, v_out, r_out, s_out, tp_out, tm_out, n, p,
      decay_plus, decay_minus);
  return cudaGetLastError();
}
