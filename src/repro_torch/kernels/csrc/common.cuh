// Device routines shared by the three kernels of the k=1 LIF step.
//
// lif_advance is the one definition of the LIF arithmetic on the card
// (lif_step.cu and phase 1 of fused_step.cu); row_dot is the one definition
// of the ELL row reduction (spike_gather.cu and phase 2 of fused_step.cu).
// Because both engines go through the same two routines, the fused and the
// unfused engine give bit-identical rasters on the card.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Host-precomputed LIF constants: decay = exp(-dt/tau_m) in f32 and
// ref_steps = round(t_ref/dt), exactly as the plain torch version computes
// them (kernels/ref.py:lif_constants), so both see the same operands.
struct LifParams {
  float v_rest;
  float v_reset;
  float v_thresh;
  float decay;
  float one_minus_decay;
  float r_m;
  float ref_steps;
};

// Exponential-Euler LIF advance with the reference's operation order
//   v_int = (v_rest + (v - v_rest) * decay) + (r_m * i_syn) * (1 - decay)
// Every operation rounds on its own (_rn intrinsics, and the library is
// built with --fmad=false): a fused multiply-add would round differently
// from the plain torch version and can move a threshold crossing.
__device__ __forceinline__ void lif_advance(float v, float refrac, float i_syn,
                                            const LifParams& p, float& v_out,
                                            float& r_out, float& s_out) {
  const bool active = refrac <= 0.0f;
  const float leak = __fmul_rn(__fsub_rn(v, p.v_rest), p.decay);
  const float drive = __fmul_rn(__fmul_rn(p.r_m, i_syn), p.one_minus_decay);
  const float v_int = __fadd_rn(__fadd_rn(p.v_rest, leak), drive);
  const float v_new = active ? v_int : p.v_reset;
  const bool spike = active && (v_new >= p.v_thresh);
  const float r_dec = __fsub_rn(refrac, 1.0f);
  // max(refrac - 1, 0) that keeps a NaN, as torch.clamp_min does
  r_out = spike ? p.ref_steps : (r_dec < 0.0f ? 0.0f : r_dec);
  v_out = spike ? p.v_reset : v_new;
  s_out = spike ? 1.0f : 0.0f;
}

// One warp reduces one ELL row: cur = sum_k w[k] * act[cols[k]].
// Lane j accumulates slots j, j+32, j+64, ... in ascending order (f32, one
// explicit fma per slot), then a fixed xor-shuffle tree combines the 32
// partial sums and lane 0 holds the result.  The order is fixed per row, so
// the sum is deterministic, and no atomics are used.  Neighbouring lanes read
// neighbouring slots, so the col/weight loads are coalesced; four slots per
// lane are in flight per iteration to cover the latency of the act lookups,
// which hit L2 (the activity vector of a full microcircuit is 308 KB).
// Padding slots carry weight 0 and col 0, so no mask is needed.  act is read
// with plain loads: in fused_step it is written earlier in the same launch.
__device__ __forceinline__ float row_dot(const int* cols, const float* w,
                                         const float* act, int K, int lane) {
  float acc = 0.0f;
  int k = lane;
  for (; k + 96 < K; k += 128) {
    const int c0 = __ldg(cols + k);
    const int c1 = __ldg(cols + k + 32);
    const int c2 = __ldg(cols + k + 64);
    const int c3 = __ldg(cols + k + 96);
    const float w0 = __ldg(w + k);
    const float w1 = __ldg(w + k + 32);
    const float w2 = __ldg(w + k + 64);
    const float w3 = __ldg(w + k + 96);
    const float a0 = act[c0];
    const float a1 = act[c1];
    const float a2 = act[c2];
    const float a3 = act[c3];
    acc = __fmaf_rn(w0, a0, acc);
    acc = __fmaf_rn(w1, a1, acc);
    acc = __fmaf_rn(w2, a2, acc);
    acc = __fmaf_rn(w3, a3, acc);
  }
  for (; k < K; k += 32) {
    acc = __fmaf_rn(__ldg(w + k), act[__ldg(cols + k)], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  return acc;
}

// Per-neuron e-trace: x' = x * decay + s, decay = exp(-dt/tau) rounded to
// f32 on the host (kernels/ref.py:trace_decay_constant).  One rounded
// multiply, then one rounded add, as the plain torch version (two eager
// ops) does.
__device__ __forceinline__ float trace_decay(float x, float s, float decay) {
  return __fadd_rn(__fmul_rn(x, decay), s);
}

// Host-side STDP constants (the registry's syn_stdp params, as f32).
struct StdpParams {
  float a_plus;
  float a_minus;
  float w_min;
  float w_max;
};

// Pair STDP of one ELL slot with the reference's operation order
//   dw = (a_plus * pre_t) * post_s - (a_minus * post_t) * pre_s
//   w' = mask > 0 ? clip(w + dw, w_min, w_max) : w
// Every operation rounds on its own.  The clip is torch.clamp's: a NaN
// passes through (fminf/fmaxf alone would drop it), and otherwise
// min(max(x, w_min), w_max).
__device__ __forceinline__ float stdp_slot(float w, float mask, float pre_t,
                                           float pre_s, float post_t,
                                           float post_s, const StdpParams& p) {
  const float pot = __fmul_rn(__fmul_rn(p.a_plus, pre_t), post_s);
  const float dep = __fmul_rn(__fmul_rn(p.a_minus, post_t), pre_s);
  const float x = __fadd_rn(w, __fsub_rn(pot, dep));
  const float clipped = isnan(x) ? x : fminf(fmaxf(x, p.w_min), p.w_max);
  return mask > 0.0f ? clipped : w;
}

static inline StdpParams make_stdp_params(float a_plus, float a_minus,
                                          float w_min, float w_max) {
  StdpParams p;
  p.a_plus = a_plus;
  p.a_minus = a_minus;
  p.w_min = w_min;
  p.w_max = w_max;
  return p;
}

static inline LifParams make_lif_params(float v_rest, float v_reset,
                                        float v_thresh, float decay,
                                        float one_minus_decay, float r_m,
                                        float ref_steps) {
  LifParams p;
  p.v_rest = v_rest;
  p.v_reset = v_reset;
  p.v_thresh = v_thresh;
  p.decay = decay;
  p.one_minus_decay = one_minus_decay;
  p.r_m = r_m;
  p.ref_steps = ref_steps;
  return p;
}
