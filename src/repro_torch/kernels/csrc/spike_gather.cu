// ELL gather-accumulate: cur[r] = sum_k w[r,k] * act[cols[r,k]], one warp per
// row.
//
// Replaces: src/repro/kernels/spike_gather.py:spike_gather_pallas
// (pallas_call at :65), which keeps the whole activity vector resident in
// VMEM and streams (block_r, block_k) col/weight panels past it.
// Bound on the H100: HBM bytes.  Every col (int32) and weight (f32) slot of
// the panel is read once: 8 bytes for one fma, so the kernel sits two orders
// of magnitude below the ridge point.  Design: one warp per row with the
// fixed per-row reduction order of row_dot (common.cuh), coalesced panel
// loads, four slots a lane in flight; the activity vector is not staged in
// shared memory but read through L2, where a microcircuit's 308 KB stay
// resident while the panels stream past.  No atomics, so the result does
// not depend on scheduling.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    spike_gather_kernel(const float* act, const int* cols, const float* w,
                        float* __restrict__ out, int R, int K) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;  // warp-uniform: every lane of a warp shares row
  const size_t off = static_cast<size_t>(row) * K;
  const float s = row_dot(cols + off, w + off, act, K, lane);
  if (lane == 0) out[row] = s;
}

}  // namespace

extern "C" int repro_spike_gather(const float* act, const int* cols,
                                  const float* w, float* out, int R, int K,
                                  void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  spike_gather_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(act, cols, w, out,
                                                             R, K);
  return cudaGetLastError();
}
