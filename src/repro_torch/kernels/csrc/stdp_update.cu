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
// mask (f32) and writes its weight: 16 bytes for about six flops, far below
// the card's ridge point.  Design: one warp per row, lanes striding the
// slots (coalesced panel loads and stores), the row's two post terms read
// once per warp, the two presynaptic vectors read through L1/L2 (a
// Brunel-size net's 50 KB vectors stay cached while the panels stream).
// No atomics and no reduction, so the result does not depend on scheduling.
// Each slot is read and written by the same lane, so w_out may be w itself
// (an in-place update); w is therefore read with plain loads, not __ldg.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

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

}  // namespace

extern "C" int repro_stdp_update(const float* w, const float* mask,
                                 const int* cols, const float* pre_t,
                                 const float* pre_s, const float* post_t,
                                 const float* post_s, float* w_out, int R,
                                 int K, float a_plus, float a_minus,
                                 float w_min, float w_max, void* stream,
                                 int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const StdpParams p = make_stdp_params(a_plus, a_minus, w_min, w_max);
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  stdp_update_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      w, mask, cols, pre_t, pre_s, post_t, post_s, w_out, R, K, p);
  return cudaGetLastError();
}
