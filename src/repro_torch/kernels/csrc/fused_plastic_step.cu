// Plastic fused k=1 LIF step in one cooperative launch: LIF advance and both
// trace decays of every neuron, a grid-wide barrier, then per (bucket, row)
// one pass over the row's real slots: the gather-accumulate from the
// pre-update weights, the masked pair-STDP write-back of the same slots in
// place, and the row's current added into the ring.
//
// Replaces: src/repro/kernels/fused_step.py:fused_plastic_step_pallas
// (pallas_call at :327, body _make_plastic_kernel:226), with the
// ring.at[(t + d) % D].add of each bucket's current that the reference runs
// after it (src/repro/snn/simulator.py, the fused plastic step).  As for
// fused_step.cu, the TPU kernel advances every neuron at grid step 0 and
// reads the spikes and traces back in later grid steps, which relies on the
// TPU running its grid in order; here cooperative_groups' grid.sync()
// separates the two phases, and the grid is sized to what can be
// co-resident, from this kernel's own occupancy query.
// Bound on the H100: HBM bytes of the real slots.  Each real slot needs its
// col and plastic mask (8 bytes), a plastic one its weight read and
// written (8 bytes), a non-plastic one its weight only under a spike (4
// bytes; it is never written); row_len adds 4 bytes a row and bucket, the
// ten state and trace vectors 40 bytes a neuron, the ring row 8 bytes a
// row and bucket.  On the Brunel net
// (15 buckets of 12,504 x 128, 65% of the slots real) the padding is never
// read.
// Design: phase 1 is lif_advance plus two trace_decay calls over a grid-
// stride loop.  Phase 2 walks the (bucket, row) items with one warp an item
// (common.cuh:plastic_walk; lane j loads the len and post terms of 32 items
// at a time).  Each real slot's col, weight and mask are loaded once, the
// spike and tr_plus' at its col gathered once from L1 (the identity
// exchange makes the spike vector the pre-spike and the gathered activity,
// tr_plus' the pre-trace), then from the same registers row_dot's fma
// chain, stdp_slot's new weight (written in place where the mask is > 0 and
// the bits change) and row_dot's xor tree; the argument that the skipped
// padding changes no bit is in common.cuh (plastic_row).  Rows r >= n_p
// take 0 for the post terms, as the plain version pads them.  With a ring,
// the warp's lane 0 adds the row's current into ring[(t + d_b) % D][r]
// (rows r < n_p) with atomicAdd, whose value the warp does not wait for: t
// is read from device memory, so one captured launch serves every step; the
// buckets' delays differ modulo D, so each ring element takes one add a
// launch, the same f32 atomic add that index_add_ of one row makes, so the
// ring is index_add_'s bit for bit.  Without a ring the currents go to
// cur[b][r] (every row).
// Chosen by timing on the H100 (PERF.md): L1 gathers (from L2 the
// kernel took 0.34 ms); one item a warp at a time at 48 registers, 40 warps
// an SM (at 64 registers, 32 warps: 5% slower; with a prefetch of the next
// item in registers: 40% slower; with cp.async copies 2-4 items ahead
// through shared memory, which also takes L1's room: 0-200% slower).
// Weights in place: a warp owns its row's slots for the launch, reads each
// one through L2 before it writes it, and no other warp reads it; the
// gathers read only the spike and trace vectors.  Padding and non-plastic
// slots are never written.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 5;
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
  float* ring;        // (D, n_p), updated in place; nullptr: the currents go to cur
  const int64_t* t;   // the step, in device memory (with a ring)
  int D;
  const int* cols[kMaxBuckets];
  float* w[kMaxBuckets];  // (R, K), updated in place
  const float* mask[kMaxBuckets];
  const int* row_len[kMaxBuckets];  // (R,) real slots a row; nullptr: K
  float* cur[kMaxBuckets];          // (R,) without a ring
  int K[kMaxBuckets];
  int wofs[kMaxBuckets];  // bucket b adds into ring row (t + wofs[b]) % D
};

// The spike vector and tr_plus' of this launch's phase 1, gathered with
// plain loads, which L1 caches: the two 50 KB vectors of the Brunel net stay
// in each SM's L1.  No SM holds a stale line of them: phase 1 only writes
// them (a store leaves no line behind in another SM's L1), nothing reads
// them before the grid barrier, and L1 starts each launch empty of global
// lines.
struct SameLaunchSrc {
  const float* spikes;
  const float* trace;
  __device__ __forceinline__ void load(int c, float& g, float& s, float& t) const {
    s = spikes[c];
    g = s;
    t = trace[c];
  }
};

// Items b * R + r, bucket-major.
struct Items {
  const PlasticArgs* a;
  int64_t t;
  __device__ __forceinline__ void terms(int i, int& len, float& pt, float& ps) const {
    const int b = i / a->R;
    const int r = i - b * a->R;
    const int* rl = a->row_len[b];
    len = rl == nullptr ? a->K[b] : __ldg(rl + r);
    const bool own = r < a->n_p;
    pt = own ? __ldcg(a->tm_out + r) : 0.0f;
    ps = own ? __ldcg(a->s_out + r) : 0.0f;
  }
  __device__ __forceinline__ PlasticRow row(int i, int len, float pt, float ps) const {
    const int b = i / a->R;
    const int r = i - b * a->R;
    const size_t off = static_cast<size_t>(r) * a->K[b];
    return PlasticRow{a->cols[b] + off, a->w[b] + off, a->mask[b] + off, len, pt, ps};
  }
  __device__ __forceinline__ void finish(int i, float sum) const {
    if ((threadIdx.x & 31) != 0) return;
    const int b = i / a->R;
    const int r = i - b * a->R;
    if (a->ring == nullptr) {
      a->cur[b][r] = sum;
    } else if (r < a->n_p) {
      // no return value: a fire-and-forget reduction, the warp goes on
      atomicAdd(a->ring + static_cast<size_t>((t + a->wofs[b]) % a->D) * a->n_p + r, sum);
    }
  }
};

// At most 48 registers a thread, so that 5 blocks (40 warps) fit an SM.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    fused_plastic_step_kernel(const __grid_constant__ PlasticArgs a) {
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
  const Items items{&a, a.ring == nullptr ? 0 : *a.t};
  plastic_walk(items, tid >> 5, nthreads >> 5, a.nd * a.R,
               SameLaunchSrc{a.s_out, a.tp_out}, a.sp, threadIdx.x & 31);
}

}  // namespace

extern "C" int repro_fused_plastic_step_max_buckets() { return kMaxBuckets; }

extern "C" int repro_fused_plastic_step(
    const float* v, const float* refrac, const float* i_tot, const float* tp,
    const float* tm, float* v_out, float* r_out, float* s_out, float* tp_out,
    float* tm_out, int n_p, int R, int nd, const void* const* cols,
    void* const* w, const void* const* mask, const void* const* row_len,
    const int* K, void* const* cur, float* ring, const int64_t* t, int D,
    const int* wofs, float v_rest, float v_reset, float v_thresh, float decay,
    float one_minus_decay, float r_m, float ref_steps, float decay_plus,
    float decay_minus, float a_plus, float a_minus, float w_min, float w_max,
    void* stream, int device) {
  if (nd < 1 || nd > kMaxBuckets || (ring != nullptr && (t == nullptr || D < 1)) ||
      static_cast<long long>(nd) * R >= (1LL << 31))
    return cudaErrorInvalidValue;
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
  a.ring = ring;
  a.t = t;
  a.D = D;
  for (int b = 0; b < kMaxBuckets; ++b) {
    const bool used = b < nd;
    a.cols[b] = used ? static_cast<const int*>(cols[b]) : nullptr;
    a.w[b] = used ? static_cast<float*>(w[b]) : nullptr;
    a.mask[b] = used ? static_cast<const float*>(mask[b]) : nullptr;
    a.row_len[b] = used ? static_cast<const int*>(row_len[b]) : nullptr;
    a.cur[b] = used && cur != nullptr ? static_cast<float*>(cur[b]) : nullptr;
    a.K[b] = used ? K[b] : 0;
    a.wofs[b] = used && wofs != nullptr ? wofs[b] : 0;
  }
  const void* kernel = reinterpret_cast<const void*>(fused_plastic_step_kernel);
  int grid = 0;
  err = resident_blocks(kernel, device, kThreads, 0, &grid);
  if (err != cudaSuccess) return err;
  // no more blocks than the larger phase has work for
  const long long lif_blocks = (n_p + kThreads - 1) / kThreads;
  const long long row_blocks =
      (static_cast<long long>(R) * nd * 32 + kThreads - 1) / kThreads;
  const long long work = lif_blocks > row_blocks ? lif_blocks : row_blocks;
  if (work < grid) grid = static_cast<int>(work > 0 ? work : 1);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
