// Device routines shared by the port's kernels.
//
// lif_advance is the one definition of the LIF arithmetic on the card
// (lif_step.cu and phase 1 of fused_step.cu).  row_dot is the ELL row
// reduction over every slot of a row (the row_dot variant of every gather);
// plastic_row is the same reduction over a row's real slots with the STDP
// update of those slots in the same pass (the plastic kernels); row_dot_active
// is the same reduction that reads
// only the real slots and only the weights of active sources (spike_gather.cu,
// event_step.cu, fused_step.cu, post_exchange.cu), and gives row_dot's result
// bit for bit when the weights are finite (argument below).  A gather whose
// weights are not all finite, or plastic, runs its row_dot variant: the same
// launch with row_dot, chosen by a template flag, whose result is the
// reference's (NaN * 0 is NaN).  Because every engine goes through these
// routines, the fused, unfused and event engines give bit-identical rasters
// on the card.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// A panel weight, widened to f32.  The gathers take f32 or bf16 panels
// (spike_gather.cu, fused_step.cu); a bf16 weight is the top half of an f32
// with the same value, so the widening is exact, and everything after it
// (the fma chain, the xor tree) runs in f32 as for an f32 panel.
__device__ __forceinline__ float load_weight(const float* w) { return __ldg(w); }
__device__ __forceinline__ float load_weight(const __nv_bfloat16* w) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(w))));
}

// Host-precomputed LIF constants: decay = exp(-dt/tau_m) in f32 and
// ref_steps = round(t_ref/dt), exactly as the plain torch version computes
// them (kernels/ref.py:lif_constants), so both see the same operands.
struct LifParams {
  float v_rest;
  float v_reset;
  float v_thresh;
  float decay;
  float one_minus_decay;
  float r_m;
  float ref_steps;
};

// Exponential-Euler LIF advance with the reference's operation order
//   v_int = (v_rest + (v - v_rest) * decay) + (r_m * i_syn) * (1 - decay)
// Every operation rounds on its own (_rn intrinsics, and the library is
// built with --fmad=false): a fused multiply-add would round differently
// from the plain torch version and can move a threshold crossing.
__device__ __forceinline__ void lif_advance(float v, float refrac, float i_syn,
                                            const LifParams& p, float& v_out,
                                            float& r_out, float& s_out) {
  const bool active = refrac <= 0.0f;
  const float leak = __fmul_rn(__fsub_rn(v, p.v_rest), p.decay);
  const float drive = __fmul_rn(__fmul_rn(p.r_m, i_syn), p.one_minus_decay);
  const float v_int = __fadd_rn(__fadd_rn(p.v_rest, leak), drive);
  const float v_new = active ? v_int : p.v_reset;
  const bool spike = active && (v_new >= p.v_thresh);
  const float r_dec = __fsub_rn(refrac, 1.0f);
  // max(refrac - 1, 0) that keeps a NaN, as torch.clamp_min does
  r_out = spike ? p.ref_steps : (r_dec < 0.0f ? 0.0f : r_dec);
  v_out = spike ? p.v_reset : v_new;
  s_out = spike ? 1.0f : 0.0f;
}

// One warp reduces one ELL row: cur = sum_k w[k] * act[cols[k]].
// Lane j accumulates slots j, j+32, j+64, ... in ascending order (f32, one
// explicit fma per slot), then a fixed xor-shuffle tree combines the 32
// partial sums and lane 0 holds the result.  The order is fixed per row, so
// the sum is deterministic, and no atomics are used.  Neighbouring lanes read
// neighbouring slots, so the col/weight loads are coalesced; four slots per
// lane are in flight per iteration to cover the latency of the act lookups,
// which hit L2 (the activity vector of a full microcircuit is 308 KB).
// Padding slots carry weight 0 and col 0, so no mask is needed.  act is read
// with plain loads: in fused_step it is written earlier in the same launch.
// W is float or __nv_bfloat16 (load_weight widens it exactly).
template <class W>
__device__ __forceinline__ float row_dot(const int* cols, const W* w,
                                         const float* act, int K, int lane) {
  float acc = 0.0f;
  int k = lane;
  for (; k + 96 < K; k += 128) {
    const int c0 = __ldg(cols + k);
    const int c1 = __ldg(cols + k + 32);
    const int c2 = __ldg(cols + k + 64);
    const int c3 = __ldg(cols + k + 96);
    const float w0 = load_weight(w + k);
    const float w1 = load_weight(w + k + 32);
    const float w2 = load_weight(w + k + 64);
    const float w3 = load_weight(w + k + 96);
    const float a0 = act[c0];
    const float a1 = act[c1];
    const float a2 = act[c2];
    const float a3 = act[c3];
    acc = __fmaf_rn(w0, a0, acc);
    acc = __fmaf_rn(w1, a1, acc);
    acc = __fmaf_rn(w2, a2, acc);
    acc = __fmaf_rn(w3, a3, acc);
  }
  for (; k < K; k += 32) {
    acc = __fmaf_rn(load_weight(w + k), act[__ldg(cols + k)], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  return acc;
}

// The activity bitmask: bit (j & 31) of word (j >> 5) is set iff act[j] != 0
// (a NaN counts as active).  One warp packs 32 ids with one ballot; `word`
// must be warp-uniform.  Ids past n are inactive.
__device__ __forceinline__ void pack_active_bits(const float* act, int n,
                                                 uint32_t* bits, int word,
                                                 int lane) {
  const int j = word * 32 + lane;
  const bool on = j < n && act[j] != 0.0f;
  const uint32_t m = __ballot_sync(0xffffffffu, on);
  if (lane == 0) bits[word] = m;
}

// Where row_dot_active tests a source's bit: a block's copy of the bitmask
// in shared memory; the bitmask in device memory written by an earlier
// launch (read-only path); the bitmask in device memory written earlier in
// the same launch (L2 only, never a stale L1 line); or the activity vector
// itself, where no bitmask is kept.
struct SharedBits {
  const uint32_t* w;
  __device__ __forceinline__ bool test(int c) const { return (w[c >> 5] >> (c & 31)) & 1u; }
};
struct LdgBits {
  const uint32_t* w;
  __device__ __forceinline__ bool test(int c) const {
    return (__ldg(w + (c >> 5)) >> (c & 31)) & 1u;
  }
};
struct L2Bits {
  const uint32_t* w;
  __device__ __forceinline__ bool test(int c) const {
    return (__ldcg(w + (c >> 5)) >> (c & 31)) & 1u;
  }
};
// No bitmask: the activity itself, tested as pack_active_bits does
// (act != 0), through the read-only path (written by an earlier launch).
struct ActBits {
  const float* a;
  __device__ __forceinline__ bool test(int c) const { return __ldg(a + c) != 0.0f; }
};

// An activity vector written earlier in the same launch (fused_step's
// spikes): read from L2, never from a stale L1 line.
struct L2Floats {
  const float* p;
  __device__ __forceinline__ float operator[](int i) const { return __ldcg(p + i); }
};

// row_dot over the first `len` slots of a row, reading a weight and an
// activity only where the source's bit is set.
//
// Kept from row_dot, exactly: lane j takes slots j, j+32, j+64, ... in
// ascending order; each slot it takes adds __fmaf_rn(w[k], act[c], acc);
// the same xor-shuffle tree combines the lanes.  What changes is which
// slots a lane takes: only those below len, and only those whose source is
// active.  Per iteration a lane loads kChunks cols (coalesced: a warp reads
// 32 neighbouring slots per chunk), with the next iteration's cols already
// in flight, tests their bits, and only for set bits loads w[k] and act[c].
//
// Why the result equals row_dot's bit for bit.  A skipped slot is either
// past len, where the row holds (col 0, weight 0) by construction, or has
// act[c] == +-0 with a finite weight.  Either way row_dot would add an exact
// +-0 product: fma(w, +-0, acc) == acc + (+-0), which is acc itself unless
// acc is -0.  acc is never -0: it starts at +0; an exact zero sum with a +0
// among its terms rounds to +0; and a nonzero exact sum never rounds to
// zero, because every product of an active slot is exact in f32 (the
// precondition below), so the sum is a nonzero multiple of the subnormal
// step 2^-149.  So every skipped fma leaves acc's bits unchanged, each
// lane's partial sum is row_dot's, and so is the tree.
// Precondition: weights and activity are finite (inf * 0 and NaN * 0 are
// NaN, which row_dot would add and this routine skips), and every product
// w[k] * act[c] of an active slot is exact in f32.  Spike vectors (0/1)
// satisfy the second always; other activity values unless a product
// underflows.  The first is the data's: the engines record per panel at
// upload whether its weights are all finite (PartitionDeviceData.reduce),
// and a panel that is not, or whose weights change (plastic), takes the
// row_dot variant of the launch.
// Act is a plain pointer, or L2Floats for an activity written earlier in
// the same launch; W as for row_dot.
template <class Bits, class Act, class W>
__device__ __forceinline__ float row_dot_active(const int* cols, const W* w,
                                                Act act, Bits bits, int len,
                                                int lane) {
  constexpr int kChunks = 8;
  constexpr int kStep = 32 * kChunks;
  float acc = 0.0f;
  int next[kChunks];
#pragma unroll
  for (int u = 0; u < kChunks; ++u) {
    const int k = 32 * u + lane;
    next[u] = k < len ? __ldg(cols + k) : 0;
  }
  for (int base = 0; base < len; base += kStep) {
    int c[kChunks];
#pragma unroll
    for (int u = 0; u < kChunks; ++u) c[u] = next[u];
    if (base + kStep < len) {  // warp-uniform
#pragma unroll
      for (int u = 0; u < kChunks; ++u) {
        const int k = base + kStep + 32 * u + lane;
        next[u] = k < len ? __ldg(cols + k) : 0;
      }
    }
    bool on[kChunks];
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int k = base + 32 * u + lane;
      on[u] = k < len && bits.test(c[u]);
    }
    float wv[kChunks];
    float av[kChunks];
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int k = base + 32 * u + lane;
      wv[u] = on[u] ? load_weight(w + k) : 0.0f;
      av[u] = on[u] ? act[c[u]] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      if (on[u]) acc = __fmaf_rn(wv[u], av[u], acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  return acc;
}

// Blocks of `kernel` (with `threads` threads and `smem` bytes of dynamic
// shared memory) that fit on the card at once.  Above the default 48 KB the
// kernel is first allowed the card's opt-in maximum of dynamic shared memory.  The last answer
// per (device, kernel, threads, smem) is kept: the wrappers call this every
// launch.
static inline cudaError_t resident_blocks(const void* kernel, int device,
                                          int threads, size_t smem,
                                          int* blocks) {
  struct Entry {
    const void* kernel;
    int device;
    int threads;
    size_t smem;
    int blocks;
  };
  static Entry cache[16] = {};
  for (const Entry& e : cache) {
    if (e.kernel == kernel && e.device == device && e.threads == threads &&
        e.smem == smem) {
      *blocks = e.blocks;
      return cudaSuccess;
    }
  }
  cudaError_t err;
  if (smem > 48 * 1024) {
    // the card's whole opt-in: a later launch of the kernel with less (a
    // cached answer sets nothing) stays allowed
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
  }
  int sms = 0;
  int per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  static int next = 0;
  cache[next] = Entry{kernel, device, threads, smem, *blocks};
  next = (next + 1) % 16;
  return cudaSuccess;
}

// Whether a bitmask of `words` words goes to shared memory: it must fit the
// card's opt-in limit per block and the caller's cap (bytes; < 0: none).
static inline cudaError_t bits_in_shared(int device, int words, int cap,
                                         bool* shared) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const long long bytes = 4LL * words;
  *shared = bytes <= optin && (cap < 0 || bytes <= cap);
  return cudaSuccess;
}

// Per-neuron e-trace: x' = x * decay + s, decay = exp(-dt/tau) rounded to
// f32 on the host (kernels/ref.py:trace_decay_constant).  One rounded
// multiply, then one rounded add, as the plain torch version (two eager
// ops) does.
__device__ __forceinline__ float trace_decay(float x, float s, float decay) {
  return __fadd_rn(__fmul_rn(x, decay), s);
}

// Host-side STDP constants (the registry's syn_stdp params, as f32).
struct StdpParams {
  float a_plus;
  float a_minus;
  float w_min;
  float w_max;
};

// Pair STDP of one ELL slot with the reference's operation order
//   dw = (a_plus * pre_t) * post_s - (a_minus * post_t) * pre_s
//   w' = mask > 0 ? clip(w + dw, w_min, w_max) : w
// Every operation rounds on its own.  The clip is torch.clamp's: a NaN
// passes through (fminf/fmaxf alone would drop it), and otherwise
// min(max(x, w_min), w_max).
__device__ __forceinline__ float stdp_slot(float w, float mask, float pre_t,
                                           float pre_s, float post_t,
                                           float post_s, const StdpParams& p) {
  const float pot = __fmul_rn(__fmul_rn(p.a_plus, pre_t), post_s);
  const float dep = __fmul_rn(__fmul_rn(p.a_minus, post_t), pre_s);
  const float x = __fadd_rn(w, __fsub_rn(pot, dep));
  const float clipped = isnan(x) ? x : fminf(fmaxf(x, p.w_min), p.w_max);
  return mask > 0.0f ? clipped : w;
}

// -- The plastic row pass (fused_plastic_step.cu, post_exchange_plastic.cu) --
//
// One warp takes a (bucket, row) item and reads each real slot of the row
// once: lane j holds slots j, j+32, j+64, j+96 of a 128-slot chunk (the
// slots of row_dot's lane j, in its order), loads each one's col, weight
// and plastic mask, gathers the activity and the pre-trace at the col, and
// from those registers runs row_dot's fma chain, then stdp_slot, whose new
// weight goes back into the same slot (in place) where the mask is > 0 and
// the bits change.  Then row_dot's xor tree.
//
// Why the sum is row_dot's over every slot, bit for bit, though the slots
// past len are never read.  The ELL pads a row after its len real slots
// with (col 0, weight +0, mask 0).  row_dot adds fma(+0, act[0], acc) for
// each; with act[0] finite (spikes are 0 or 1) the product is an exact
// +-0, and acc + (+-0) is acc unless acc is -0.  acc starts at +0, and
// under round-to-nearest a sum is -0 only when both terms are -0, so acc is
// never -0 before a padding slot (row_dot_active's argument, above, covers
// the same step).  So each lane's partial sum is row_dot's, and so is the
// tree.  The padding's new weight is its old one (stdp_slot keeps a slot
// whose mask is 0), so not writing it changes nothing either.
// Precondition: act[0] is finite (the spikes are; the kernels' callers
// pass spike vectors), and each row's len real slots come first.
constexpr int kPlasticChunk = 128;  // slots of a chunk: 4 a lane

struct PlasticChunk {
  int c[4];
  float w[4];
  float m[4];
};

// What a warp knows of its item before it reads the slots: where the row
// lies, its real slots and its post-synaptic terms (0 for rows >= n_p).
struct PlasticRow {
  const int* cols;
  float* w;  // read and written by this warp alone in the launch
  const float* mask;
  int len;
  float post_t;
  float post_s;
};

// The lane's slots base + lane + 32u (u < 4) below len.  The weights are
// written back in this launch (by this thread, after this read), so they
// are read through L2 (ld.global.cg), not the read-only path.
__device__ __forceinline__ void load_plastic_chunk(PlasticChunk& x, const PlasticRow& row,
                                                   int base, int lane) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int k = base + 32 * u + lane;
    const bool on = k < row.len;
    x.c[u] = on ? __ldg(row.cols + k) : 0;
    x.w[u] = on ? __ldcg(row.w + k) : 0.0f;
    x.m[u] = on ? __ldg(row.mask + k) : 0.0f;
  }
}

// One chunk: the gathers of its slots (src.load(col, g, s, t): the gather's
// activity g, STDP's pre-spike s and pre-trace t at col), the fma chain
// into acc, and the STDP write-back.  Returns acc.
template <class Src>
__device__ __forceinline__ float plastic_chunk(const PlasticChunk& x, const PlasticRow& row,
                                               int base, int lane, const Src& src,
                                               const StdpParams& sp, float acc) {
  float g[4], s[4], t[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    g[u] = s[u] = t[u] = 0.0f;
    if (base + 32 * u + lane < row.len) src.load(x.c[u], g[u], s[u], t[u]);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (base + 32 * u + lane < row.len) acc = __fmaf_rn(x.w[u], g[u], acc);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int k = base + 32 * u + lane;
    if (k < row.len && x.m[u] > 0.0f) {
      const float nw = stdp_slot(x.w[u], x.m[u], t[u], s[u], row.post_t, row.post_s, sp);
      if (__float_as_uint(nw) != __float_as_uint(x.w[u])) row.w[k] = nw;
    }
  }
  return acc;
}

// The whole item, its first chunk already in `first`; returns the row's
// sum on every lane (row_dot's tree).
template <class Src>
__device__ __forceinline__ float plastic_row(const PlasticRow& row, const PlasticChunk& first,
                                             const Src& src, const StdpParams& sp, int lane) {
  float acc = plastic_chunk(first, row, 0, lane, src, sp, 0.0f);
  for (int base = kPlasticChunk; base < row.len; base += kPlasticChunk) {  // warp-uniform
    PlasticChunk x;
    load_plastic_chunk(x, row, base, lane);
    acc = plastic_chunk(x, row, base, lane, src, sp, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  return acc;
}

// A warp's walk over its items first, first + stride, ... < total.  Lane j
// loads the len and post terms of the warp's item j of each 32
// (items.terms(i)), which the lanes then take by shuffles, so that an item
// does not wait on a load of its own before its slots' loads go out.
// items.row(i, len, post_t, post_s) gives the row; items.finish(i, sum)
// takes each item's sum (on every lane).  The slots' loads of one item at a
// time: a prefetch of the next item's first chunk in registers (92-96
// registers a thread, 16 warps an SM) and copies of it through shared
// memory by cp.async, 2-4 items ahead, were both slower on the H100 than
// the warps that one item a warp leaves room for (PERF.md).
template <class Items, class Src>
__device__ __forceinline__ void plastic_walk(const Items& items, int first, int stride,
                                             int total, const Src& src, const StdpParams& sp,
                                             int lane) {
  if (first >= total) return;  // warp-uniform
  const int n = (total - first + stride - 1) / stride;
  int len = 0;
  float pt = 0.0f, ps = 0.0f;
  for (int j = 0; j < n; ++j) {
    if ((j & 31) == 0) {
      const int mine = j + lane;
      len = 0;
      pt = ps = 0.0f;
      if (mine < n) items.terms(first + mine * stride, len, pt, ps);
    }
    const int sl = j & 31;
    const PlasticRow row =
        items.row(first + j * stride, __shfl_sync(0xffffffffu, len, sl),
                  __shfl_sync(0xffffffffu, pt, sl), __shfl_sync(0xffffffffu, ps, sl));
    PlasticChunk x;
    load_plastic_chunk(x, row, 0, lane);
    items.finish(first + j * stride, plastic_row(row, x, src, sp, lane));
  }
}

static inline StdpParams make_stdp_params(float a_plus, float a_minus,
                                          float w_min, float w_max) {
  StdpParams p;
  p.a_plus = a_plus;
  p.a_minus = a_minus;
  p.w_min = w_min;
  p.w_max = w_max;
  return p;
}

static inline LifParams make_lif_params(float v_rest, float v_reset,
                                        float v_thresh, float decay,
                                        float one_minus_decay, float r_m,
                                        float ref_steps) {
  LifParams p;
  p.v_rest = v_rest;
  p.v_reset = v_reset;
  p.v_thresh = v_thresh;
  p.decay = decay;
  p.one_minus_decay = one_minus_decay;
  p.r_m = r_m;
  p.ref_steps = ref_steps;
  return p;
}
