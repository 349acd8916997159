// Fused k=1 LIF step in one cooperative launch: LIF advance of every neuron,
// a grid-wide barrier, then the gather-accumulate of every delay bucket from
// the fresh spike vector.
//
// Replaces: src/repro/kernels/fused_step.py:fused_lif_step_pallas
// (pallas_call at :140, body _make_kernel:73).  The TPU kernel advances all
// neurons at grid step 0 and reads the spikes back in later grid steps; that
// relies on the TPU running its grid in order.  CUDA blocks run in no fixed
// order, so here the two phases are separated by cooperative_groups'
// grid.sync(), and the grid is sized to what can be co-resident
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SM count), which
// cudaLaunchCooperativeKernel requires.
// Bound on the H100: HBM bytes: the panels of all buckets (8 bytes a slot,
// as row_dot reads them) dominate; the state vectors add 24 bytes a
// neuron.  Design: phase 1 is lif_advance over a grid-stride loop; phase 2
// walks (bucket, row) pairs, one warp per row, with row_dot (common.cuh),
// which spike_gather's row_dot_active matches bit for bit.  The spike
// vector goes to global memory once and is read back through L2.  No state
// padding is needed: unlike the TPU kernel's lane-padded vectors
// (fused_step.py:182-188, padded v = v_reset with zero input), the loops
// here are bounds-checked.  Rows R > n_p carry weight 0
// and give current 0.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBuckets = 32;  // kernels/fused_step.py:MAX_BUCKETS

struct FusedArgs {
  const float* v;
  const float* refrac;
  const float* i_tot;
  float* v_out;
  float* r_out;
  float* s_out;
  int n_p;
  int R;
  int nd;
  LifParams p;
  const int* cols[kMaxBuckets];
  const float* w[kMaxBuckets];
  float* cur[kMaxBuckets];
  int K[kMaxBuckets];
};

__global__ void __launch_bounds__(kThreads) fused_step_kernel(const FusedArgs a) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  for (int i = tid; i < a.n_p; i += nthreads) {
    lif_advance(a.v[i], a.refrac[i], a.i_tot[i], a.p, a.v_out[i], a.r_out[i],
                a.s_out[i]);
  }
  // every spike of this step is written before any row reads one
  cg::this_grid().sync();
  const int lane = threadIdx.x & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  for (int b = 0; b < a.nd; ++b) {
    const int K = a.K[b];
    const int* cols = a.cols[b];
    const float* w = a.w[b];
    float* cur = a.cur[b];
    for (int r = warp; r < a.R; r += nwarps) {
      const size_t off = static_cast<size_t>(r) * K;
      const float s = row_dot(cols + off, w + off, a.s_out, K, lane);
      if (lane == 0) cur[r] = s;
    }
  }
}

}  // namespace

extern "C" int repro_fused_step_max_buckets() { return kMaxBuckets; }

extern "C" int repro_fused_step(const float* v, const float* refrac,
                                const float* i_tot, float* v_out, float* r_out,
                                float* s_out, int n_p, int R, int nd,
                                const void* const* cols, const void* const* w,
                                const int* K, void* const* cur, float v_rest,
                                float v_reset, float v_thresh, float decay,
                                float one_minus_decay, float r_m,
                                float ref_steps, void* stream, int device) {
  if (nd < 1 || nd > kMaxBuckets) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FusedArgs a;
  a.v = v;
  a.refrac = refrac;
  a.i_tot = i_tot;
  a.v_out = v_out;
  a.r_out = r_out;
  a.s_out = s_out;
  a.n_p = n_p;
  a.R = R;
  a.nd = nd;
  a.p = make_lif_params(v_rest, v_reset, v_thresh, decay, one_minus_decay, r_m,
                        ref_steps);
  for (int b = 0; b < kMaxBuckets; ++b) {
    const bool used = b < nd;
    a.cols[b] = used ? static_cast<const int*>(cols[b]) : nullptr;
    a.w[b] = used ? static_cast<const float*>(w[b]) : nullptr;
    a.cur[b] = used ? static_cast<float*>(cur[b]) : nullptr;
    a.K[b] = used ? K[b] : 0;
  }
  int grid = 0;
  err = resident_blocks(reinterpret_cast<const void*>(fused_step_kernel), device, kThreads,
                        0, &grid);
  if (err != cudaSuccess) return err;
  // no more blocks than the larger phase has work for
  const long long lif_blocks = (n_p + kThreads - 1) / kThreads;
  const long long row_blocks =
      (static_cast<long long>(R) * nd * 32 + kThreads - 1) / kThreads;
  const long long work = lif_blocks > row_blocks ? lif_blocks : row_blocks;
  if (work < grid) grid = static_cast<int>(work > 0 ? work : 1);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_step_kernel),
                                    dim3(grid), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
