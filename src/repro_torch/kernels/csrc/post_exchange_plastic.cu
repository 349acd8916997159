// Plastic post-exchange half of the split step: the ring rotate, every delay
// bucket's gather-accumulate from the pre-update weights, and the masked
// pair-STDP update of every slot, in one pass over the panels, one warp per
// row.
//
// Replaces: src/repro/kernels/fused_step.py:fused_post_exchange_plastic_pallas
// (pallas_call at :901, body _make_post_plastic_kernel:845) and
// fused_post_exchange_remote_plastic_pallas (pallas_call at :751, body
// _make_post_remote_plastic_kernel:694).  The two differ only in what the
// gather reads and in the clear: the serialized pass gathers the full
// exchanged activity and rotates the ring; the overlap mode's remote pass
// gathers the activity with the own slice zeroed (act_gather != act) and
// does not rotate (clear == nullptr).  STDP always reads the full activity
// and pre-trace.  The TPU kernels keep the two (three) global vectors
// resident in VMEM and ride the post terms along the row grid as
// (block_r, 1) columns.
// Bound on the H100: HBM bytes.  Each slot reads its col, weight and
// plastic mask and writes its new weight (16 bytes); the ring is read and
// written once; the global activity and pre-trace vectors stay in L2.
// Design: one warp per row r < R (rows >= n_p are padding: no gather, and 0
// for the post terms, as the plain version pads them).  Per bucket the warp
// runs row_dot over the pre-update weights (which spike_gather.cu's
// row_dot_active matches bit for bit, so the currents are bit-identical to
// the unfused engine's), then a second
// pass over the row's slots applies stdp_slot (the routine of
// stdp_update.cu, so the weights are bit-identical too).  The new weights go
// to separate buffers: row_dot reads the weights through the read-only
// cache, which needs them unchanged for the whole launch.  Then lane j
// updates ring slots j, j+32, ... with the reference's formulation, as
// post_exchange.cu does.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxBuckets = 32;  // kernels/split_step.py:MAX_BUCKETS

struct PlasticPostArgs {
  const float* act_gather;  // (n,) what the gather reads
  const float* act;         // (n,) the presynaptic spikes of STDP
  const float* pre_trace;   // (n,)
  const float* ring_in;     // (D, n_p)
  float* ring_out;          // (D, n_p), may alias ring_in
  const float* clear;       // (D,) or nullptr: no rotate
  const float* onehot;      // (nd, D)
  const float* post_trace;  // (n_p,)
  const float* post_spike;  // (n_p,)
  int n_p;
  int D;
  int R;
  int nd;
  StdpParams sp;
  const int* cols[kMaxBuckets];
  const float* w[kMaxBuckets];
  const float* mask[kMaxBuckets];
  float* w_out[kMaxBuckets];
  int K[kMaxBuckets];
};

__global__ void __launch_bounds__(kThreads)
    post_exchange_plastic_kernel(const PlasticPostArgs a) {
  __shared__ float cur_s[kWarpsPerBlock][kMaxBuckets];
  const int wib = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarpsPerBlock + wib;
  const int lane = threadIdx.x & 31;
  if (r >= a.R) return;  // warp-uniform
  const bool own = r < a.n_p;
  const float post_t = own ? a.post_trace[r] : 0.0f;
  const float post_s = own ? a.post_spike[r] : 0.0f;
  float* cur = cur_s[wib];
  for (int b = 0; b < a.nd; ++b) {
    const int K = a.K[b];
    const size_t off = static_cast<size_t>(r) * K;
    const int* cols = a.cols[b] + off;
    const float* w = a.w[b] + off;
    if (own) {
      const float c = row_dot(cols, w, a.act_gather, K, lane);
      if (lane == 0) cur[b] = c;
    }
    const float* mask = a.mask[b] + off;
    float* w_out = a.w_out[b] + off;
    for (int k = lane; k < K; k += 32) {
      const int col = __ldg(cols + k);
      w_out[k] = stdp_slot(__ldg(w + k), __ldg(mask + k), __ldg(a.pre_trace + col),
                           __ldg(a.act + col), post_t, post_s, a.sp);
    }
  }
  if (!own) return;  // warp-uniform
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

extern "C" int repro_post_exchange_plastic_max_buckets() { return kMaxBuckets; }

extern "C" int repro_post_exchange_plastic(
    const float* act_gather, const float* act, const float* pre_trace,
    const float* ring_in, float* ring_out, const float* clear,
    const float* onehot, const float* post_trace, const float* post_spike,
    int n_p, int D, int R, int nd, const void* const* cols,
    const void* const* w, const void* const* mask, void* const* w_out,
    const int* K, float a_plus, float a_minus, float w_min, float w_max,
    void* stream, int device) {
  if (nd < 1 || nd > kMaxBuckets || D < 1 || R < n_p) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  PlasticPostArgs a;
  a.act_gather = act_gather;
  a.act = act;
  a.pre_trace = pre_trace;
  a.ring_in = ring_in;
  a.ring_out = ring_out;
  a.clear = clear;
  a.onehot = onehot;
  a.post_trace = post_trace;
  a.post_spike = post_spike;
  a.n_p = n_p;
  a.D = D;
  a.R = R;
  a.nd = nd;
  a.sp = make_stdp_params(a_plus, a_minus, w_min, w_max);
  for (int b = 0; b < kMaxBuckets; ++b) {
    const bool used = b < nd;
    a.cols[b] = used ? static_cast<const int*>(cols[b]) : nullptr;
    a.w[b] = used ? static_cast<const float*>(w[b]) : nullptr;
    a.mask[b] = used ? static_cast<const float*>(mask[b]) : nullptr;
    a.w_out[b] = used ? static_cast<float*>(w_out[b]) : nullptr;
    a.K[b] = used ? K[b] : 0;
  }
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  post_exchange_plastic_kernel<<<blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
