// Pair STDP over one ELL panel: for every slot,
//   w'[r,k] = stdp_slot(w[r,k], mask[r,k], pre_t[col], pre_s[col],
//                       post_t[r], post_s[r]),   col = cols[r,k]
// one warp per row.
//
// Replaces: src/repro/kernels/stdp_update.py:stdp_update_pallas (pallas_call
// at :70, body _kernel:19), which keeps the two presynaptic vectors resident
// in VMEM and streams (block_r, block_k) col/weight/mask panels past them
// with the postsynaptic terms broadcast as (block_r, 1) columns.
// Bound on the H100: HBM bytes.  Each slot reads its col (int32), weight and
// mask and writes its weight: 16 bytes for about six flops with f32 weights,
// 10 (bf16 mask) or 12 (f32 mask) with bf16 weights, far below the card's
// ridge point.  Design: one warp per row, lanes striding the slots
// (coalesced panel loads and stores), the row's two post terms read once per
// warp, the two presynaptic vectors read through L1/L2 (a Brunel-size net's
// 50 KB vectors stay cached while the panels stream).
// No atomics and no reduction, so the result does not depend on scheduling.
// Each slot is read and written by the same lane, so w_out may be w itself
// (an in-place update); w is therefore read with plain loads, not __ldg.
//
// bf16 weights follow the reference kernel's types: it casts the four
// vectors to the weights' type, its Python scalars are weak-typed, so every
// operation is a bf16 one.  Here each is an f32 _rn operation rounded to
// bf16 (stdp_clip_bf16); the host passes the scalars already rounded.  The
// mask is f32 or bf16 (the reference's signature has it in the weights'
// type).  A slot the mask leaves keeps its bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// stdp_slot's clipped value with every operand and every operation rounded
// to bf16 (the caller applies the mask).  A product of two bf16 values is
// exact in f32 and a sum of two rounds once to f32's 24 bits, at least
// 2 x 8 + 2, so rounding the f32 result to bf16 gives the bf16 operation's
// result.  The clip is exact.
__device__ __forceinline__ float stdp_clip_bf16(float w, float pre_t, float pre_s,
                                                float post_t, float post_s,
                                                const StdpParams& p) {
  pre_t = bf16_round(pre_t);
  pre_s = bf16_round(pre_s);
  const float pot = bf16_round(__fmul_rn(bf16_round(__fmul_rn(p.a_plus, pre_t)), post_s));
  const float dep = bf16_round(__fmul_rn(bf16_round(__fmul_rn(p.a_minus, post_t)), pre_s));
  const float x = bf16_round(__fadd_rn(w, bf16_round(__fsub_rn(pot, dep))));
  return isnan(x) ? x : fminf(fmaxf(x, p.w_min), p.w_max);
}

__global__ void __launch_bounds__(kThreads)
    stdp_update_kernel(const float* w, const float* __restrict__ mask,
                       const int* __restrict__ cols,
                       const float* __restrict__ pre_t,
                       const float* __restrict__ pre_s,
                       const float* __restrict__ post_t,
                       const float* __restrict__ post_s, float* w_out, int R,
                       int K, StdpParams p) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;  // warp-uniform
  const float pt = __ldg(post_t + row);
  const float ps = __ldg(post_s + row);
  const size_t off = static_cast<size_t>(row) * K;
  for (int k = lane; k < K; k += 32) {
    const int c = __ldg(cols + off + k);
    w_out[off + k] = stdp_slot(w[off + k], __ldg(mask + off + k),
                               __ldg(pre_t + c), __ldg(pre_s + c), pt, ps, p);
  }
}

// bf16 weights; M (the mask) is float or __nv_bfloat16
template <class M>
__global__ void __launch_bounds__(kThreads)
    stdp_update_bf16_kernel(const __nv_bfloat16* w, const M* __restrict__ mask,
                            const int* __restrict__ cols,
                            const float* __restrict__ pre_t,
                            const float* __restrict__ pre_s,
                            const float* __restrict__ post_t,
                            const float* __restrict__ post_s,
                            __nv_bfloat16* w_out, int R, int K, StdpParams p) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;  // warp-uniform
  const float pt = bf16_round(__ldg(post_t + row));
  const float ps = bf16_round(__ldg(post_s + row));
  const size_t off = static_cast<size_t>(row) * K;
  for (int k = lane; k < K; k += 32) {
    const int c = __ldg(cols + off + k);
    const __nv_bfloat16 wk = w[off + k];
    w_out[off + k] = load_weight(mask + off + k) > 0.0f
                         ? __float2bfloat16_rn(stdp_clip_bf16(
                               __bfloat162float(wk), __ldg(pre_t + c),
                               __ldg(pre_s + c), pt, ps, p))
                         : wk;
  }
}

}  // namespace

// w_bf16: the weights (and w_out) are bf16, else f32; mask_bf16: the mask is
// bf16 (only with bf16 weights), else f32.  With bf16 weights the scalars
// come rounded to bf16.
extern "C" int repro_stdp_update(const void* w, const void* mask,
                                 const int* cols, const float* pre_t,
                                 const float* pre_s, const float* post_t,
                                 const float* post_s, void* w_out, int R,
                                 int K, int w_bf16, int mask_bf16,
                                 float a_plus, float a_minus, float w_min,
                                 float w_max, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (mask_bf16 && !w_bf16) return cudaErrorInvalidValue;
  const StdpParams p = make_stdp_params(a_plus, a_minus, w_min, w_max);
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (!w_bf16) {
    stdp_update_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(w), static_cast<const float*>(mask), cols,
        pre_t, pre_s, post_t, post_s, static_cast<float*>(w_out), R, K, p);
  } else if (mask_bf16) {
    stdp_update_bf16_kernel<bf><<<blocks, kThreads, 0, s>>>(
        static_cast<const bf*>(w), static_cast<const bf*>(mask), cols, pre_t,
        pre_s, post_t, post_s, static_cast<bf*>(w_out), R, K, p);
  } else {
    stdp_update_bf16_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const bf*>(w), static_cast<const float*>(mask), cols,
        pre_t, pre_s, post_t, post_s, static_cast<bf*>(w_out), R, K, p);
  }
  return cudaGetLastError();
}
