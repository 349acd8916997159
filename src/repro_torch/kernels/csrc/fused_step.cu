// Fused k=1 LIF step in one cooperative launch: LIF advance of every neuron
// and the spike bitmask, a grid-wide barrier, then the gather-accumulate of
// every delay bucket from the fresh spike vector, reading only the real
// slots and only the weights of spiking sources.
//
// Replaces: src/repro/kernels/fused_step.py:fused_lif_step_pallas
// (pallas_call at :140, body _make_kernel:73).  The TPU kernel advances all
// neurons at grid step 0 and reads the spikes back in later grid steps; that
// relies on the TPU running its grid in order.  CUDA blocks run in no fixed
// order, so here the two phases are separated by cooperative_groups'
// grid.sync(), and the grid is sized to what can be co-resident
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SM count, counting the
// dynamic shared memory: common.cuh:resident_blocks), which
// cudaLaunchCooperativeKernel requires.
// Bound on the H100: HBM bytes, and only those that carry information: the
// col of every real slot (4 bytes), the weight of every slot whose source
// spiked (one 32-byte sector per group of 8 slots holding one), and the
// state vectors (24 bytes a neuron).  On the microcircuit 45% of the slots
// are padding and more than 99% of the real weights meet a silent source,
// so reading every slot's col and weight, as row_dot does (8 bytes a slot,
// 4.11 GB a step), moves 3.6 times the bytes.
// Design:
//   1. one warp per 32 neurons: lif_advance of each (common.cuh, the LIF of
//      every engine), then one __ballot_sync packs the 32 spikes into a word
//      of the bitmask in device memory (9.6 KB for 77,172 neurons);
//   2. grid.sync(); each block copies the bitmask into its dynamic shared
//      memory (ld.cg: written in this launch by other blocks);
//   3. (bucket, row) pairs, one warp per row: row_dot_active (common.cuh)
//      reads the row's first row_len[r] cols, tests each source's bit in
//      shared memory, and only for a set bit loads the weight and the spike
//      (ld.cg, written in this launch).
// The currents equal row_dot's bit for bit (the argument, and its
// precondition of finite weights, in common.cuh), so this engine's raster
// equals every other engine's.  A bitmask larger than the card's shared
// memory per block (about 1.8 M neurons) is read from L2 instead; no case
// falls back to the plain version.  The row_dot variant (dense != 0; the
// template flag kRowDot) is the same launch with row_dot over every slot and
// no bitmask: it runs for panels whose weights are not all finite (the
// caller's choice from the data, PartitionDeviceData.reduce), where a NaN
// weight of a silent source gives the reference's NaN, and it is the
// bit-exact oracle of the active variant on the card.  No state padding is
// needed: unlike the TPU kernel's lane-padded vectors (fused_step.py:182-188,
// padded v = v_reset with zero input), the loops here are bounds-checked.
// Rows R > n_p carry no real slot and give current 0.
// Weights: f32 or bf16 panels (the template W, one type for every bucket of a
// launch, widened exactly by common.cuh:load_weight), accumulated in f32 as
// the reference's kernel does (fused_step.py:101); the currents are f32.
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
  uint32_t* bits;  // (words,) spike bitmask, written in phase 1
  int words;       // ceil(n_p / 32)
  int n_p;
  int R;
  int nd;
  LifParams p;
  const int* cols[kMaxBuckets];
  const void* w[kMaxBuckets];  // f32 or bf16 (the kernel's W)
  const int* row_len[kMaxBuckets];  // (R,) real slots a row; null: K
  float* cur[kMaxBuckets];
  int K[kMaxBuckets];
};

// at most 64 registers a thread, so that 4 blocks (32 warps) fit an SM
template <bool kShared, bool kRowDot, class W>
__global__ void __launch_bounds__(kThreads, 4) fused_step_kernel(const FusedArgs a) {
  extern __shared__ uint32_t staged[];
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  for (int word = warp; word < a.words; word += nwarps) {  // warp-uniform
    const int i = word * 32 + lane;
    float s = 0.0f;
    if (i < a.n_p) {
      float v, r;
      lif_advance(a.v[i], a.refrac[i], a.i_tot[i], a.p, v, r, s);
      a.v_out[i] = v;
      a.r_out[i] = r;
      a.s_out[i] = s;
    }
    if (!kRowDot) {
      const uint32_t m = __ballot_sync(0xffffffffu, s != 0.0f);
      if (lane == 0) a.bits[word] = m;
    }
  }
  // every spike and bit of this step is written before any row reads one
  cg::this_grid().sync();
  if (kShared && !kRowDot) {
    for (int i = threadIdx.x; i < a.words; i += blockDim.x) staged[i] = __ldcg(a.bits + i);
    __syncthreads();
  }
  for (int b = 0; b < a.nd; ++b) {
    const int K = a.K[b];
    const int* cols = a.cols[b];
    const W* w = static_cast<const W*>(a.w[b]);
    const int* row_len = a.row_len[b];
    float* cur = a.cur[b];
    for (int r = warp; r < a.R; r += nwarps) {
      const size_t off = static_cast<size_t>(r) * K;
      float s;
      if (kRowDot) {
        s = row_dot(cols + off, w + off, a.s_out, K, lane);
      } else {
        const int len = row_len == nullptr ? K : min(__ldg(row_len + r), K);
        const L2Floats spikes{a.s_out};
        s = kShared ? row_dot_active(cols + off, w + off, spikes, SharedBits{staged}, len, lane)
                    : row_dot_active(cols + off, w + off, spikes, L2Bits{a.bits}, len, lane);
      }
      if (lane == 0) cur[r] = s;
    }
  }
}

}  // namespace

extern "C" int repro_fused_step_max_buckets() { return kMaxBuckets; }

// bits: scratch of ceil(n_p / 32) words.  row_len: per bucket a pointer to
// (R,) int32, or null for rows K long.  smem_cap: the most bytes of shared
// memory the bitmask may take (< 0: the card's limit; 0: read it from L2).
// dense != 0: the row_dot variant (bits, row_len and smem_cap unused).
// w_bf16 != 0: every bucket's weights are bf16, else f32.
extern "C" int repro_fused_step(const float* v, const float* refrac,
                                const float* i_tot, float* v_out, float* r_out,
                                float* s_out, int n_p, int R, int nd,
                                const void* const* cols, const void* const* w, int w_bf16,
                                const void* const* row_len, const int* K,
                                void* const* cur, uint32_t* bits, int smem_cap,
                                int dense, float v_rest, float v_reset,
                                float v_thresh, float decay,
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
  a.bits = bits;
  a.words = (n_p + 31) / 32;
  a.n_p = n_p;
  a.R = R;
  a.nd = nd;
  a.p = make_lif_params(v_rest, v_reset, v_thresh, decay, one_minus_decay, r_m,
                        ref_steps);
  for (int b = 0; b < kMaxBuckets; ++b) {
    const bool used = b < nd;
    a.cols[b] = used ? static_cast<const int*>(cols[b]) : nullptr;
    a.w[b] = used ? w[b] : nullptr;
    a.row_len[b] = used ? static_cast<const int*>(row_len[b]) : nullptr;
    a.cur[b] = used ? static_cast<float*>(cur[b]) : nullptr;
    a.K[b] = used ? K[b] : 0;
  }
  bool shared = false;
  if (!dense) {
    err = bits_in_shared(device, a.words, smem_cap, &shared);
    if (err != cudaSuccess) return err;
  }
  const void* kernel =
      w_bf16 ? (dense    ? reinterpret_cast<const void*>(fused_step_kernel<false, true, __nv_bfloat16>)
                : shared ? reinterpret_cast<const void*>(fused_step_kernel<true, false, __nv_bfloat16>)
                         : reinterpret_cast<const void*>(fused_step_kernel<false, false, __nv_bfloat16>))
             : (dense    ? reinterpret_cast<const void*>(fused_step_kernel<false, true, float>)
                : shared ? reinterpret_cast<const void*>(fused_step_kernel<true, false, float>)
                         : reinterpret_cast<const void*>(fused_step_kernel<false, false, float>));
  const size_t smem = shared ? 4 * static_cast<size_t>(a.words) : 0;
  int grid = 0;
  err = resident_blocks(kernel, device, kThreads, smem, &grid);
  if (err != cudaSuccess) return err;
  // no more blocks than the larger phase has work for
  const long long lif_blocks = (32LL * a.words + kThreads - 1) / kThreads;
  const long long row_blocks =
      (static_cast<long long>(R) * nd * 32 + kThreads - 1) / kThreads;
  const long long work = lif_blocks > row_blocks ? lif_blocks : row_blocks;
  if (work < grid) grid = static_cast<int>(work > 0 ? work : 1);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
