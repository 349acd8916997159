// Event-driven post-exchange step in one cooperative launch: compress the
// activity vector to spike ids and a bitmask, flag the row blocks those ids
// touch, then clear the delivered ring slot and gather-accumulate only the
// flagged rows of every delay bucket into the ring.  At k=1 the activity is
// the partition's own spike vector; in the split engine (fused_split_event)
// it is the exchanged (n_global,) vector while the ring has the partition's
// n_p rows, and the overlap mode's remote pass runs with no clear (clear ==
// 0), as the reference passes a clear mask of ones there
// (src/repro/snn/simulator.py:370-376, :608-614).  The ring slots come from
// the step t, read from device memory: the delivered slot is t % D and bucket
// b adds to (t + off_b) % D, off_b its delay (host constants of the net), so
// one captured launch serves every step.
//
// Replaces: src/repro/kernels/event_step.py:event_post_exchange_pallas
// (pallas_call at :198, body _make_event_kernel:135), together with the
// event_select compaction (:102) that the reference runs as jnp ops before
// it.  The TPU kernel skips an unflagged block by repeating the previous
// block index in a scalar-prefetch index map, so Pallas skips the HBM fetch.
// CUDA has no such fetch to skip: here a warp reads a block's flag and does
// not touch its panel rows at all.
// Bound on the H100: HBM bytes.  On the microcircuit a step's few hundred
// spikes flag every block, so the flagged rows' slots dominate: the col of
// every real slot (4 bytes) and the weight of every slot whose source is
// active.  Padding and the weights of silent sources are never read.  The
// compaction reads the (n,) spike vector once and the flag phase reads one
// touch byte per (block, spike id).
// Design, three phases separated by grid.sync():
//   1. one warp per 32 ids of the spike vector: each spiking neuron takes a
//      slot of the id buffer with atomicAdd on a counter the host zeroed,
//      and a ballot packs the 32 ids' activity (act != 0) into one word of
//      the bitmask; the same phase clears the delivered ring slot.  The ids
//      land in no fixed order, but only their set is used: a block's flag
//      is an OR over the ids, and more ids than the buffer holds flags
//      every block (the reference's in-step dense fallback), so the result
//      is deterministic;
//   2. each block copies the bitmask (9.6 KB for 77,172 ids) into its
//      dynamic shared memory; one thread block per (bucket, row block) pair
//      ORs the touch bytes of the ids (__syncthreads_or) and writes the
//      flag;
//   3. the (bucket, row) walk, one warp per row, skipping rows whose block
//      is not flagged: row_dot_active (common.cuh) reads the row's first
//      row_len[r] cols, tests each source's bit in shared memory, and only
//      for a set bit loads the weight and act[c]; lane 0 adds the row's sum
//      to its ring slot, bucket by bucket in order.  row_dot_active equals
//      the dense row_dot bit for bit (the argument and its precondition,
//      finite weights and activity, are in common.cuh), so the ring is
//      bit-identical to the dense engines' on flagged rows, and unflagged
//      rows (whose dense sum is a signed zero) keep their value.
// A bitmask larger than the card's shared memory per block (about 1.8 M
// ids) is read from L2 instead (ld.cg: it was written in this launch); no
// case falls back to the plain version.  The occupancy query that sizes the
// cooperative grid counts the dynamic shared memory.
// The row_dot variant (dense != 0; the template flag kRowDot) is the same
// launch with row_dot over every slot of each flagged row, and no bitmask:
// it runs for panels whose weights are not all finite (the caller's choice
// from the data), and is the bit-exact oracle of the active variant.
// Weights: f32 or bf16 panels (the template W, one type for every bucket of a
// launch, widened exactly by common.cuh:load_weight), summed in f32 as the
// reference's kernel does (event_step.py:154); the ring is f32.
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBuckets = 32;  // kernels/event_step.py:MAX_BUCKETS

struct EventArgs {
  const float* act;  // (n,) spike vector, 0/1 floats
  int n;
  uint32_t* bits;  // (words,) activity bitmask, written in phase 1
  int words;       // ceil(n / 32)
  const uint8_t* touch;  // (nd, nb, n): 1 iff id j has a valid slot in block
  int* ids;              // (cap,) id buffer
  int* count;            // spikes this step; zeroed by the host
  int cap;
  int* flags;   // (nd, nb) out
  float* ring;  // (D, n_p), updated in place
  int n_p;
  const int64_t* t;  // the step, in device memory
  int D;
  int clear;  // != 0: clear the delivered slot t % D
  int nb;
  int block_r;
  int nd;
  const int* cols[kMaxBuckets];
  const void* w[kMaxBuckets];  // f32 or bf16 (the kernel's W)
  const int* row_len[kMaxBuckets];  // (R,) real slots a row; null: K
  int K[kMaxBuckets];
  int wofs[kMaxBuckets];  // bucket b adds to ring slot (t + wofs[b]) % D
};

// at most 64 registers a thread, so that 4 blocks (32 warps) fit an SM
template <bool kShared, bool kRowDot, class W>
__global__ void __launch_bounds__(kThreads, 4) event_step_kernel(const EventArgs a) {
  extern __shared__ uint32_t staged[];
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int64_t t = *a.t;
  float* ring_slot = a.ring + static_cast<size_t>(t % a.D) * a.n_p;
  for (int word = warp; word < a.words; word += nwarps) {  // warp-uniform
    const int j = word * 32 + lane;
    if (j < a.n && a.act[j] > 0.0f) {
      const int pos = atomicAdd(a.count, 1);
      if (pos < a.cap) a.ids[pos] = j;
    }
    if (!kRowDot) pack_active_bits(a.act, a.n, a.bits, word, lane);
  }
  if (a.clear) {
    for (int r = tid; r < a.n_p; r += nthreads) ring_slot[r] = 0.0f;
  }
  cg::grid_group grid = cg::this_grid();
  grid.sync();

  // the counter, the ids and the bitmask were written by other blocks in
  // this launch: read them from L2 (ld.cg), never from a stale L1 line
  if (kShared && !kRowDot) {
    for (int i = threadIdx.x; i < a.words; i += blockDim.x) staged[i] = __ldcg(a.bits + i);
    __syncthreads();
  }
  const int total = __ldcg(a.count);
  const bool overflow = total > a.cap;
  const int n_ids = overflow ? 0 : total;
  for (int p = blockIdx.x; p < a.nd * a.nb; p += gridDim.x) {
    const uint8_t* touch = a.touch + static_cast<size_t>(p) * a.n;
    int hit = overflow ? 1 : 0;
    for (int i = threadIdx.x; i < n_ids && !hit; i += blockDim.x) {
      hit = __ldg(touch + __ldcg(a.ids + i)) != 0;
    }
    const int flag = __syncthreads_or(hit);
    if (threadIdx.x == 0) a.flags[p] = flag;
  }
  grid.sync();

  for (int b = 0; b < a.nd; ++b) {
    const int K = a.K[b];
    const int* cols = a.cols[b];
    const W* w = static_cast<const W*>(a.w[b]);
    const int* row_len = a.row_len[b];
    const int* flags = a.flags + static_cast<size_t>(b) * a.nb;
    float* ring_w = a.ring + static_cast<size_t>((t + a.wofs[b]) % a.D) * a.n_p;
    for (int r = warp; r < a.n_p; r += nwarps) {
      if (!__ldcg(flags + r / a.block_r)) continue;  // warp-uniform
      const size_t off = static_cast<size_t>(r) * K;
      float s;
      if (kRowDot) {
        s = row_dot(cols + off, w + off, a.act, K, lane);
      } else {
        const int len = row_len == nullptr ? K : min(__ldg(row_len + r), K);
        s = kShared ? row_dot_active(cols + off, w + off, a.act, SharedBits{staged}, len, lane)
                    : row_dot_active(cols + off, w + off, a.act, L2Bits{a.bits}, len, lane);
      }
      if (lane == 0) ring_w[r] = __fadd_rn(ring_w[r], s);
    }
  }
}

}  // namespace

extern "C" int repro_event_step_max_buckets() { return kMaxBuckets; }

// ring: (D, n_p); t: the step, one int64 >= 0 in device memory; clear != 0
// clears ring slot t % D; bucket b adds to slot (t + wofs[b]) % D, wofs[b] in
// [0, D).  bits: scratch of ceil(n / 32) words.  row_len: per bucket a
// pointer to (R,) int32, or null for rows K long.  smem_cap: the most bytes
// of shared memory the bitmask may take (< 0: the card's limit; 0: read it
// from L2).  dense != 0: the row_dot variant (bits, row_len and smem_cap
// unused).  w_bf16 != 0: every bucket's weights are bf16, else f32.
extern "C" int repro_event_step(const float* act, int n, const uint8_t* touch,
                                int* ids, int* count, int cap, int* flags,
                                float* ring, int n_p, const int64_t* t, int D, int clear,
                                int nb, int block_r, int nd, const void* const* cols,
                                const void* const* w, int w_bf16,
                                const void* const* row_len, const int* K,
                                const int* wofs, uint32_t* bits, int smem_cap,
                                int dense, void* stream, int device) {
  if (nd < 1 || nd > kMaxBuckets || block_r < 1 || cap < 1 || D < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  EventArgs a;
  a.act = act;
  a.n = n;
  a.bits = bits;
  a.words = (n + 31) / 32;
  a.touch = touch;
  a.ids = ids;
  a.count = count;
  a.cap = cap;
  a.flags = flags;
  a.ring = ring;
  a.n_p = n_p;
  a.t = t;
  a.D = D;
  a.clear = clear;
  a.nb = nb;
  a.block_r = block_r;
  a.nd = nd;
  for (int b = 0; b < kMaxBuckets; ++b) {
    const bool used = b < nd;
    a.cols[b] = used ? static_cast<const int*>(cols[b]) : nullptr;
    a.w[b] = used ? w[b] : nullptr;
    a.row_len[b] = used ? static_cast<const int*>(row_len[b]) : nullptr;
    a.K[b] = used ? K[b] : 0;
    a.wofs[b] = used ? wofs[b] : 0;
  }
  bool shared = false;
  if (!dense) {
    err = bits_in_shared(device, a.words, smem_cap, &shared);
    if (err != cudaSuccess) return err;
  }
  const void* kernel =
      w_bf16 ? (dense    ? reinterpret_cast<const void*>(event_step_kernel<false, true, __nv_bfloat16>)
                : shared ? reinterpret_cast<const void*>(event_step_kernel<true, false, __nv_bfloat16>)
                         : reinterpret_cast<const void*>(event_step_kernel<false, false, __nv_bfloat16>))
             : (dense    ? reinterpret_cast<const void*>(event_step_kernel<false, true, float>)
                : shared ? reinterpret_cast<const void*>(event_step_kernel<true, false, float>)
                         : reinterpret_cast<const void*>(event_step_kernel<false, false, float>));
  const size_t smem = shared ? 4 * static_cast<size_t>(a.words) : 0;
  int grid = 0;
  err = resident_blocks(kernel, device, kThreads, smem, &grid);
  if (err != cudaSuccess) return err;
  // no more blocks than the largest phase has work for
  const long long scan_blocks =
      (std::max(32LL * a.words, static_cast<long long>(n_p)) + kThreads - 1) / kThreads;
  const long long flag_blocks = static_cast<long long>(nd) * nb;
  const long long row_blocks =
      (static_cast<long long>(n_p) * 32 + kThreads - 1) / kThreads;
  const long long work = std::max(scan_blocks, std::max(flag_blocks, row_blocks));
  if (work < grid) grid = static_cast<int>(work > 0 ? work : 1);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, smem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
