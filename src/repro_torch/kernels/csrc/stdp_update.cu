// Pair STDP over ELL panels, in two forms.
//
// The per-panel op (ops.stdp_update): for every slot of one (R, K) panel,
//   w'[r,k] = stdp_slot(w[r,k], mask[r,k], pre_t[col], pre_s[col],
//                       post_t[r], post_s[r]),   col = cols[r,k]
// one warp per row, every slot read and written (out may be w: in place).
// The engine form (ops.stdp_update_step): the same update over every delay
// bucket of a partition's step, in one launch, in place, over each row's
// real slots only, with the post terms taken in the kernel.
//
// Replaces: src/repro/kernels/stdp_update.py:stdp_update_pallas (pallas_call
// at :70, body _kernel:19), which keeps the two presynaptic vectors resident
// in VMEM and streams (block_r, block_k) col/weight/mask panels past them
// with the postsynaptic terms broadcast as (block_r, 1) columns; the
// reference's unfused step calls it once a bucket
// (src/repro/snn/simulator.py:665), with post terms padded to the bucket's
// rows or taken through a split bucket's row_map (:656-664).
//
// Per panel.  Bound on the H100: HBM bytes.  Each slot reads its col
// (int32), weight and mask and writes its weight: 16 bytes for about six
// flops with f32 weights, 10 (bf16 mask) or 12 (f32 mask) with bf16
// weights, far below the card's ridge point.  Design: one warp per row,
// lanes striding the slots (coalesced panel loads and stores), the row's
// two post terms read once per warp, the two presynaptic vectors read
// through L1/L2 (a Brunel-size net's 50 KB vectors stay cached while the
// panels stream).  No atomics and no reduction, so the result does not
// depend on scheduling.  Each slot is read and written by the same lane,
// so w_out may be w itself (an in-place update); w is therefore read with
// plain loads, not __ldg.
//
// bf16 weights follow the reference kernel's types: it casts the four
// vectors to the weights' type, its Python scalars are weak-typed, so every
// operation is a bf16 one.  Here each is an f32 _rn operation rounded to
// bf16 (stdp_clip_bf16); the host passes the scalars already rounded.  The
// mask is f32 or bf16 (the reference's signature has it in the weights'
// type).  A slot the mask leaves keeps its bits.
//
// Engine form.  Bound on the H100: HBM bytes of what the step's inputs
// need: the mask (4 B) at each real slot of a row that holds a plastic
// slot, the col and the weight (8 B) only at a plastic one, the weight
// written only where its bits change, the 16 B item a listed row and the
// four vectors (the 50 KB presynaptic ones stay in L1/L2).  The work is a list of items made once at upload
// (kernels/stdp_update.py:stdp_step_plan; the masks, row lengths and
// row maps never change): one int4 {bucket, row, real slots, post row} for
// each (bucket, row) that holds a plastic slot, bucket-major, so a row
// without one (an inhibitory target, a padding row) is never visited.  A
// warp walks kItems consecutive items (consecutive rows of one panel):
// lane j loads item j's entry and its two post terms (post_t[post row],
// post_s[post row], the split bucket's row_map or the row itself, 0 for a
// row >= n_p), the lanes take them by shuffles, and for each item lane j
// holds the slots j, j + 32, ... below the row's real slots, kSlots at a
// time: the masks and the cols, then the weight of each plastic slot only,
// then pre_t[col] and pre_s[col] of those, then stdp_slot (common.cuh) and
// a store only where the new weight's bits differ (plastic_chunk's rule).
// Loading the col beside the mask reads 4 B more at each real slot that is
// not plastic, but saves a dependent round trip: 0.0672 ms against 0.0727
// with the mask read first (the Brunel net on the H100; PERF.md).  Listing
// only the rows that hold a plastic slot beat listing every row with a
// real slot (0.0672 against 0.0790 ms).  Every bucket of the step is one
// launch (up to kMaxBuckets a launch; the wrapper makes one launch a group
// of that many).  The weights' pointers arrive by value at every launch
// (the carry's, cloned by every run; never the uploaded panels), the item
// list by pointer.
// Why it equals the per-panel op on every slot, bit for bit: a slot whose
// mask is not > 0 keeps its bits in both; the plan refuses masks with a
// plastic slot past a row's real slots, so every plastic slot is visited;
// its stdp_slot is the per-panel kernel's, with the same post terms.  So
// the order of the buckets, and of the updates against a step's gathers
// (each gather reads only its own bucket's weights), changes no bit.
// kSlots, kItems and kMinBlocks (the registers) were chosen by timing
// other values of them on the H100 (PERF.md).
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

// -- engine form -------------------------------------------------------------

constexpr int kMaxBuckets = 32;  // kernels/stdp_update.py:STEP_MAX_BUCKETS
constexpr int kStepThreads = 256;
constexpr int kStepWarps = kStepThreads / 32;
constexpr int kSlots = 4;      // slots a lane holds at once: 32 * kSlots a chunk
constexpr int kItems = 8;      // consecutive items a warp walks (<= 32)
constexpr int kMinBlocks = 6;  // blocks an SM: at most 40 registers a thread

struct StdpStepArgs {
  const int4* items;  // (n_items,) {bucket, row, real slots, post row or -1}
  int n_items;
  const float* pre_t;   // (n,)
  const float* pre_s;   // (n,)
  const float* post_t;  // (n_p,)
  const float* post_s;  // (n_p,)
  StdpParams sp;
  const int* cols[kMaxBuckets];
  float* w[kMaxBuckets];  // (R, K), updated in place
  const float* mask[kMaxBuckets];
  int K[kMaxBuckets];
};

// One item's real slots.  The weights are written back in this launch (by
// this thread, after this read), so they are read through L2 (__ldcg).
__device__ __forceinline__ void stdp_step_row(const StdpStepArgs& a, int b, int r, int len,
                                              float pt, float ps, int lane) {
  const size_t off = static_cast<size_t>(r) * a.K[b];
  const float* mask = a.mask[b] + off;
  const int* cols = a.cols[b] + off;
  float* w = a.w[b] + off;
  for (int base = 0; base < len; base += 32 * kSlots) {  // warp-uniform
    float m[kSlots], wv[kSlots], t[kSlots], s[kSlots];
    int c[kSlots];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const int k = base + 32 * u + lane;
      const bool on = k < len;
      m[u] = on ? __ldg(mask + k) : 0.0f;
      c[u] = on ? __ldg(cols + k) : 0;
      wv[u] = t[u] = s[u] = 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      if (m[u] > 0.0f) wv[u] = __ldcg(w + base + 32 * u + lane);
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      if (m[u] > 0.0f) {
        t[u] = __ldg(a.pre_t + c[u]);
        s[u] = __ldg(a.pre_s + c[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      if (m[u] > 0.0f) {
        const float nw = stdp_slot(wv[u], m[u], t[u], s[u], pt, ps, a.sp);
        if (__float_as_uint(nw) != __float_as_uint(wv[u])) w[base + 32 * u + lane] = nw;
      }
    }
  }
}

__global__ void __launch_bounds__(kStepThreads, kMinBlocks)
    stdp_update_step_kernel(const __grid_constant__ StdpStepArgs a) {
  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * kStepWarps + (threadIdx.x >> 5)) * kItems;
  if (first >= a.n_items) return;  // warp-uniform
  const int n = min(kItems, a.n_items - first);
  int4 it = make_int4(0, 0, 0, -1);
  float pt = 0.0f, ps = 0.0f;
  if (lane < n) {
    it = __ldg(a.items + first + lane);
    if (it.w >= 0) {
      pt = __ldg(a.post_t + it.w);
      ps = __ldg(a.post_s + it.w);
    }
  }
  for (int j = 0; j < n; ++j) {
    stdp_step_row(a, __shfl_sync(0xffffffffu, it.x, j), __shfl_sync(0xffffffffu, it.y, j),
                  __shfl_sync(0xffffffffu, it.z, j), __shfl_sync(0xffffffffu, pt, j),
                  __shfl_sync(0xffffffffu, ps, j), lane);
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

extern "C" int repro_stdp_update_step_max_buckets() { return kMaxBuckets; }

// One launch over the items of nd <= kMaxBuckets buckets (item.x indexes
// this launch's cols/w/mask/K); f32 weights, updated in place.
extern "C" int repro_stdp_update_step(const void* items, int n_items, const float* pre_t,
                                      const float* pre_s, const float* post_t,
                                      const float* post_s, int nd, const void* const* cols,
                                      void* const* w, const void* const* mask, const int* K,
                                      float a_plus, float a_minus, float w_min, float w_max,
                                      void* stream, int device) {
  if (nd < 1 || nd > kMaxBuckets || n_items < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  StdpStepArgs a;
  a.items = static_cast<const int4*>(items);
  a.n_items = n_items;
  a.pre_t = pre_t;
  a.pre_s = pre_s;
  a.post_t = post_t;
  a.post_s = post_s;
  a.sp = make_stdp_params(a_plus, a_minus, w_min, w_max);
  for (int b = 0; b < kMaxBuckets; ++b) {
    const bool used = b < nd;
    a.cols[b] = used ? static_cast<const int*>(cols[b]) : nullptr;
    a.w[b] = used ? static_cast<float*>(w[b]) : nullptr;
    a.mask[b] = used ? static_cast<const float*>(mask[b]) : nullptr;
    a.K[b] = used ? K[b] : 0;
  }
  const int per_block = kStepWarps * kItems;
  const int blocks = (n_items + per_block - 1) / per_block;
  stdp_update_step_kernel<<<blocks, kStepThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
