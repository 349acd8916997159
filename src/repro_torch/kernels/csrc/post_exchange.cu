// Post-exchange half of the split step: the ring rotate and every delay
// bucket's ELL gather-accumulate into the ring, one warp per row.
//
// Replaces: src/repro/kernels/fused_step.py:fused_post_exchange_pallas
// (pallas_call at :545, body _make_post_kernel:513) and both of its
// wrappers: fused_post_exchange_local_pallas (:652, local sub-panels and
// the partition's own (n_p,) activity) and fused_post_exchange_remote_pallas
// (:673, remote sub-panels, a clear mask of ones: here clear == nullptr).
// The TPU kernel keeps the exchanged activity vector resident in VMEM and
// streams (block_r, K) panel blocks past it, reading and writing the
// (D, block_r) ring block once per grid step.
// Bound on the H100: HBM bytes.  Every col (int32) and weight (f32) slot is
// read once (8 bytes a slot, one fma), and the (D, n_p) ring is read and
// written once; the activity vector (308 KB at microcircuit scale) stays in
// L2 while the panels stream past.
// Design: one warp per row r < n_p.  For each bucket the warp runs row_dot
// (common.cuh, the routine of fused_step.cu, which the gathers'
// row_dot_active matches bit for bit, so the currents are bit-identical to
// every other engine's) and parks the sum in
// shared memory; then lane j updates ring slots j, j+32, ... of the row with
// the reference's formulation (ground rule (e) of ROADMAP.md):
//   x = ring[s][r] * clear[s];  then per bucket in order  x += onehot[b][s] * cur_b
// with every operation rounded on its own.  Each ring element is read and
// written by one thread, so the update may be in place (ring_out == ring).
// The ring access is strided (D slots of one row per warp); for D = 15 that
// is 120 bytes a row against kilobytes of panel, so it is left as it is.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxBuckets = 32;  // kernels/split_step.py:MAX_BUCKETS

struct PostArgs {
  const float* act;      // (n,) activity the panels' col ids index
  const float* ring_in;  // (D, n_p)
  float* ring_out;       // (D, n_p), may alias ring_in
  const float* clear;    // (D,) or nullptr: no rotate (a clear of ones)
  const float* onehot;   // (nd, D)
  int n_p;
  int D;
  int nd;
  const int* cols[kMaxBuckets];
  const float* w[kMaxBuckets];
  int K[kMaxBuckets];
};

__global__ void __launch_bounds__(kThreads)
    post_exchange_kernel(const PostArgs a) {
  __shared__ float cur_s[kWarpsPerBlock][kMaxBuckets];
  const int wib = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarpsPerBlock + wib;
  const int lane = threadIdx.x & 31;
  if (r >= a.n_p) return;  // warp-uniform
  float* cur = cur_s[wib];
  for (int b = 0; b < a.nd; ++b) {
    const size_t off = static_cast<size_t>(r) * a.K[b];
    const float c = row_dot(a.cols[b] + off, a.w[b] + off, a.act, a.K[b], lane);
    if (lane == 0) cur[b] = c;
  }
  __syncwarp();
  for (int s = lane; s < a.D; s += 32) {
    const size_t idx = static_cast<size_t>(s) * a.n_p + r;
    float x = a.ring_in[idx];
    if (a.clear != nullptr) x = __fmul_rn(x, a.clear[s]);
    for (int b = 0; b < a.nd; ++b) {
      x = __fadd_rn(x, __fmul_rn(a.onehot[b * a.D + s], cur[b]));
    }
    a.ring_out[idx] = x;
  }
}

}  // namespace

extern "C" int repro_post_exchange_max_buckets() { return kMaxBuckets; }

extern "C" int repro_post_exchange(const float* act, const float* ring_in,
                                   float* ring_out, const float* clear,
                                   const float* onehot, int n_p, int D, int nd,
                                   const void* const* cols,
                                   const void* const* w, const int* K,
                                   void* stream, int device) {
  if (nd < 1 || nd > kMaxBuckets || D < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  PostArgs a;
  a.act = act;
  a.ring_in = ring_in;
  a.ring_out = ring_out;
  a.clear = clear;
  a.onehot = onehot;
  a.n_p = n_p;
  a.D = D;
  a.nd = nd;
  for (int b = 0; b < kMaxBuckets; ++b) {
    const bool used = b < nd;
    a.cols[b] = used ? static_cast<const int*>(cols[b]) : nullptr;
    a.w[b] = used ? static_cast<const float*>(w[b]) : nullptr;
    a.K[b] = used ? K[b] : 0;
  }
  const int blocks = (n_p + kWarpsPerBlock - 1) / kWarpsPerBlock;
  post_exchange_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
