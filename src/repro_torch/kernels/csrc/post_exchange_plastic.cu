// Plastic post-exchange half of the split step: every delay bucket's
// gather-accumulate from the pre-update weights and the masked pair-STDP
// update of its slots, in one pass over each row's real slots, then the
// ring rotate and add of the reference's formulation.
//
// Replaces: src/repro/kernels/fused_step.py:fused_post_exchange_plastic_pallas
// (pallas_call at :901, body _make_post_plastic_kernel:845) and
// fused_post_exchange_remote_plastic_pallas (pallas_call at :751, body
// _make_post_remote_plastic_kernel:694).  The two differ only in what the
// gather reads and in the clear: the serialized pass gathers the full
// exchanged activity and rotates the ring; the overlap mode's remote pass
// gathers the activity with the own slice zeroed and does not rotate
// (clear == nullptr).  STDP always reads the full activity and pre-trace.
// The TPU kernels keep the two (three) global vectors resident in VMEM and
// ride the post terms along the row grid as (block_r, 1) columns.
// Bound on the H100: HBM bytes of the real slots.  Each real slot needs its
// col and plastic mask (8 bytes), a plastic one its weight read and
// written (8 bytes), a non-plastic one its weight only under an active id
// of what the gather reads (4 bytes; it is never written); row_len adds 4
// bytes a row and bucket; the ring is read and written once;
// the global activity and pre-trace vectors stay in L2.
// Design: a block takes kRows consecutive rows, and its 8 warps walk the
// block's (bucket, row) items (common.cuh:plastic_walk), so that a row's
// buckets spread over the warps.  Per item the warp reads each real slot's col, weight and mask
// once, gathers act and pre_trace at its col once, and from those registers
// runs row_dot's fma chain, stdp_slot's new weight (written in place where
// the mask is > 0 and the bits change; the routine of stdp_update.cu, so
// the weights are bit-identical) and row_dot's xor tree; the argument that
// the skipped padding changes no bit is in common.cuh (plastic_row).  What
// the gather reads: act itself (the serialized pass), act with the own
// slice's ids [own_lo, own_lo + own_n) read as +0 in registers (the remote
// pass of an engine whose own slice is one range of ids: the product with
// +0 equals the one with a +0 read from a zeroed copy, and one gather
// serves both the current and STDP), or a vector of its own.  Rows
// r >= n_p (padding) take 0 for the post terms, as the plain version pads
// them, and add nothing to the ring.  The sums go to shared memory; after
// the block's barrier each thread updates ring elements (s, r) of the
// block's rows with the reference's formulation, as post_exchange.cu does:
// ring * clear, then per bucket in order + onehot[b][s] * cur[b][r].
// Weights in place: a warp owns its item's slots for the launch, reads
// each one through L2 before it writes it, and no other warp reads it.
// Chosen by timing on the H100 (PERF.md): 4 rows a block at 40
// registers, 48 warps an SM (2 rows at 64 registers: 8-10% slower; 1, 2 or
// 8 rows, a register prefetch of the next item, or cp.async copies 2-3
// items ahead: slower still).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // rows a block: 60 (bucket, row) items on the Brunel net
// at most 40 registers a thread, so that 6 blocks (48 warps) fit an SM
constexpr int kMinBlocks = 6;
constexpr int kMaxBuckets = 32;  // kernels/split_step.py:MAX_BUCKETS

enum GatherMode { kAct = 0, kOwn = 1, kSeparate = 2 };

struct PlasticPostArgs {
  const float* act_gather;  // (n,) what the gather reads (kSeparate)
  const float* act;         // (n,) the presynaptic spikes of STDP
  const float* pre_trace;   // (n,)
  int own_lo;               // kOwn: the ids read as +0 by the gather
  int own_n;
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
  float* w[kMaxBuckets];  // (R, K), updated in place
  const float* mask[kMaxBuckets];
  const int* row_len[kMaxBuckets];  // (R,) real slots a row; nullptr: K
  int K[kMaxBuckets];
};

template <int kMode>
struct ExchangedSrc {
  const PlasticPostArgs* a;
  __device__ __forceinline__ void load(int c, float& g, float& s, float& t) const {
    s = __ldg(a->act + c);
    t = __ldg(a->pre_trace + c);
    if (kMode == kAct) {
      g = s;
    } else if (kMode == kOwn) {
      g = static_cast<unsigned>(c - a->own_lo) < static_cast<unsigned>(a->own_n) ? 0.0f : s;
    } else {
      g = __ldg(a->act_gather + c);
    }
  }
};

// The block's items b * rows + rr for row r0 + rr, bucket-major.
struct Items {
  const PlasticPostArgs* a;
  int r0;
  int rows;
  float (*cur)[kMaxBuckets];
  __device__ __forceinline__ void terms(int i, int& len, float& pt, float& ps) const {
    const int b = i / rows;
    const int r = r0 + (i - b * rows);
    const int* rl = a->row_len[b];
    len = rl == nullptr ? a->K[b] : __ldg(rl + r);
    const bool own = r < a->n_p;
    pt = own ? __ldg(a->post_trace + r) : 0.0f;
    ps = own ? __ldg(a->post_spike + r) : 0.0f;
  }
  __device__ __forceinline__ PlasticRow row(int i, int len, float pt, float ps) const {
    const int b = i / rows;
    const int r = r0 + (i - b * rows);
    const size_t off = static_cast<size_t>(r) * a->K[b];
    return PlasticRow{a->cols[b] + off, a->w[b] + off, a->mask[b] + off, len, pt, ps};
  }
  __device__ __forceinline__ void finish(int i, float sum) const {
    const int b = i / rows;
    if ((threadIdx.x & 31) == 0) cur[i - b * rows][b] = sum;
  }
};

template <int kMode>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    post_exchange_plastic_kernel(const __grid_constant__ PlasticPostArgs a) {
  __shared__ float cur_s[kRows][kMaxBuckets];
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, a.R - r0);
  const Items items{&a, r0, rows, cur_s};
  plastic_walk(items, threadIdx.x >> 5, kWarps, rows * a.nd, ExchangedSrc<kMode>{&a}, a.sp,
               threadIdx.x & 31);
  __syncthreads();
  const int own_rows = min(rows, a.n_p - r0);
  for (int e = threadIdx.x; e < a.D * own_rows; e += kThreads) {
    const int s = e / own_rows;
    const int rr = e - s * own_rows;
    const size_t idx = static_cast<size_t>(s) * a.n_p + r0 + rr;
    float x = a.ring_in[idx];
    if (a.clear != nullptr) x = __fmul_rn(x, a.clear[s]);
    for (int b = 0; b < a.nd; ++b) {
      x = __fadd_rn(x, __fmul_rn(a.onehot[b * a.D + s], cur_s[rr][b]));
    }
    a.ring_out[idx] = x;
  }
}

template <int kMode>
cudaError_t launch(const PlasticPostArgs& a, cudaStream_t stream) {
  const int blocks = (a.R + kRows - 1) / kRows;
  post_exchange_plastic_kernel<kMode><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_post_exchange_plastic_max_buckets() { return kMaxBuckets; }

extern "C" int repro_post_exchange_plastic(
    const float* act_gather, const float* act, const float* pre_trace, int own_lo, int own_n,
    const float* ring_in, float* ring_out, const float* clear,
    const float* onehot, const float* post_trace, const float* post_spike,
    int n_p, int D, int R, int nd, const void* const* cols,
    void* const* w, const void* const* mask, const void* const* row_len,
    const int* K, float a_plus, float a_minus, float w_min, float w_max,
    void* stream, int device) {
  if (nd < 1 || nd > kMaxBuckets || D < 1 || R < n_p) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  PlasticPostArgs a;
  a.act_gather = act_gather;
  a.act = act;
  a.pre_trace = pre_trace;
  a.own_lo = own_lo;
  a.own_n = own_n;
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
    a.w[b] = used ? static_cast<float*>(w[b]) : nullptr;
    a.mask[b] = used ? static_cast<const float*>(mask[b]) : nullptr;
    a.row_len[b] = used ? static_cast<const int*>(row_len[b]) : nullptr;
    a.K[b] = used ? K[b] : 0;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act_gather == nullptr) return launch<kOwn>(a, s);
  if (act_gather == act) return launch<kAct>(a, s);
  return launch<kSeparate>(a, s);
}
