// Plastic fused k=1 LIF step in one cooperative launch: LIF advance and both
// trace decays of every neuron, a grid-wide barrier, then per (bucket, row)
// the gather-accumulate from the pre-update weights and the masked pair-STDP
// write-back of the same row.
//
// Replaces: src/repro/kernels/fused_step.py:fused_plastic_step_pallas
// (pallas_call at :327, body _make_plastic_kernel:226).  As for fused_step.cu,
// the TPU kernel advances every neuron at grid step 0 and reads the spikes and
// traces back in later grid steps, which relies on the TPU running its grid
// in order; here cooperative_groups' grid.sync() separates the two phases,
// and the grid is sized to what can be co-resident, from this kernel's own
// occupancy query (it uses more registers than fused_step_kernel, so that
// kernel's figure could be refused by cudaLaunchCooperativeKernel).
// Bound on the H100: HBM bytes.  Each slot reads its col, weight and plastic
// mask and writes its new weight (16 bytes); the ten state and trace vectors
// add 40 bytes a neuron and the currents 4 bytes a row and bucket.
// Design: phase 1 is lif_advance plus two trace_decay calls over a grid-
// stride loop.  Phase 2 walks (bucket, row) pairs, one warp per row: first
// row_dot over the pre-update weights, which spike_gather's row_dot_active
// matches bit for bit, so the currents are bit-identical to the unfused
// engine's; then a second pass
// over the row's slots applies stdp_slot, the same routine as stdp_update.
// The second pass re-reads the row's cols and weights, which mostly hit L1
// and L2 right after the first pass; loading each slot once is left to a
// later change.  The identity exchange makes the spike vector the pre-spike
// and tr_plus' the pre-trace; rows r >= n_p take 0 for the post terms, as
// the plain version pads them.  The new weights go to separate buffers:
// row_dot reads the weights with __ldg, which needs them unchanged for the
// whole launch.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBuckets = 32;  // kernels/fused_step.py:MAX_BUCKETS

struct PlasticArgs {
  const float* v;
  const float* refrac;
  const float* i_tot;
  const float* tp;
  const float* tm;
  float* v_out;
  float* r_out;
  float* s_out;
  float* tp_out;
  float* tm_out;
  int n_p;
  int R;
  int nd;
  LifParams p;
  float decay_plus;
  float decay_minus;
  StdpParams sp;
  const int* cols[kMaxBuckets];
  const float* w[kMaxBuckets];
  const float* mask[kMaxBuckets];
  float* w_out[kMaxBuckets];
  float* cur[kMaxBuckets];
  int K[kMaxBuckets];
};

__global__ void __launch_bounds__(kThreads)
    fused_plastic_step_kernel(const PlasticArgs a) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  for (int i = tid; i < a.n_p; i += nthreads) {
    float s;
    lif_advance(a.v[i], a.refrac[i], a.i_tot[i], a.p, a.v_out[i], a.r_out[i],
                s);
    a.s_out[i] = s;
    a.tp_out[i] = trace_decay(a.tp[i], s, a.decay_plus);
    a.tm_out[i] = trace_decay(a.tm[i], s, a.decay_minus);
  }
  // every spike and trace of this step is written before any row reads one
  cg::this_grid().sync();
  const int lane = threadIdx.x & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  for (int b = 0; b < a.nd; ++b) {
    const int K = a.K[b];
    for (int r = warp; r < a.R; r += nwarps) {
      const size_t off = static_cast<size_t>(r) * K;
      const int* cols = a.cols[b] + off;
      const float* w = a.w[b] + off;
      const float c = row_dot(cols, w, a.s_out, K, lane);
      if (lane == 0) a.cur[b][r] = c;
      const bool own = r < a.n_p;
      const float post_t = own ? a.tm_out[r] : 0.0f;
      const float post_s = own ? a.s_out[r] : 0.0f;
      const float* mask = a.mask[b] + off;
      float* w_out = a.w_out[b] + off;
      for (int k = lane; k < K; k += 32) {
        const int col = __ldg(cols + k);
        w_out[k] = stdp_slot(__ldg(w + k), __ldg(mask + k), a.tp_out[col],
                             a.s_out[col], post_t, post_s, a.sp);
      }
    }
  }
}

}  // namespace

extern "C" int repro_fused_plastic_step_max_buckets() { return kMaxBuckets; }

extern "C" int repro_fused_plastic_step(
    const float* v, const float* refrac, const float* i_tot, const float* tp,
    const float* tm, float* v_out, float* r_out, float* s_out, float* tp_out,
    float* tm_out, int n_p, int R, int nd, const void* const* cols,
    const void* const* w, const void* const* mask, void* const* w_out,
    const int* K, void* const* cur, float v_rest, float v_reset,
    float v_thresh, float decay, float one_minus_decay, float r_m,
    float ref_steps, float decay_plus, float decay_minus, float a_plus,
    float a_minus, float w_min, float w_max, void* stream, int device) {
  if (nd < 1 || nd > kMaxBuckets) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  PlasticArgs a;
  a.v = v;
  a.refrac = refrac;
  a.i_tot = i_tot;
  a.tp = tp;
  a.tm = tm;
  a.v_out = v_out;
  a.r_out = r_out;
  a.s_out = s_out;
  a.tp_out = tp_out;
  a.tm_out = tm_out;
  a.n_p = n_p;
  a.R = R;
  a.nd = nd;
  a.p = make_lif_params(v_rest, v_reset, v_thresh, decay, one_minus_decay, r_m,
                        ref_steps);
  a.decay_plus = decay_plus;
  a.decay_minus = decay_minus;
  a.sp = make_stdp_params(a_plus, a_minus, w_min, w_max);
  for (int b = 0; b < kMaxBuckets; ++b) {
    const bool used = b < nd;
    a.cols[b] = used ? static_cast<const int*>(cols[b]) : nullptr;
    a.w[b] = used ? static_cast<const float*>(w[b]) : nullptr;
    a.mask[b] = used ? static_cast<const float*>(mask[b]) : nullptr;
    a.w_out[b] = used ? static_cast<float*>(w_out[b]) : nullptr;
    a.cur[b] = used ? static_cast<float*>(cur[b]) : nullptr;
    a.K[b] = used ? K[b] : 0;
  }
  int grid = 0;
  err = resident_blocks(reinterpret_cast<const void*>(fused_plastic_step_kernel), device, kThreads,
                        0, &grid);
  if (err != cudaSuccess) return err;
  // no more blocks than the larger phase has work for
  const long long lif_blocks = (n_p + kThreads - 1) / kThreads;
  const long long row_blocks =
      (static_cast<long long>(R) * nd * 32 + kThreads - 1) / kThreads;
  const long long work = lif_blocks > row_blocks ? lif_blocks : row_blocks;
  if (work < grid) grid = static_cast<int>(work > 0 ? work : 1);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fused_plastic_step_kernel), dim3(grid),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
