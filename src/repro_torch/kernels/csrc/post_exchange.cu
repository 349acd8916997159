// Post-exchange half of the split step: the ring rotate and every delay
// bucket's ELL gather-accumulate into the ring, one warp per row, reading
// only the real slots and only the weights of active sources.
//
// Replaces: src/repro/kernels/fused_step.py:fused_post_exchange_pallas
// (pallas_call at :545, body _make_post_kernel:513) and both of its
// wrappers: fused_post_exchange_local_pallas (:652, local sub-panels and
// the partition's own (n_p,) activity) and fused_post_exchange_remote_pallas
// (:673, remote sub-panels, a clear mask of ones: here clear == nullptr).
// The TPU kernel keeps the exchanged activity vector resident in VMEM and
// streams (block_r, K) panel blocks past it, reading and writing the
// (D, block_r) ring block once per grid step.
// Bound on the H100: HBM bytes, and only those that carry information: the
// col of every real slot (4 bytes), the weight of every slot whose source
// is active (one 32-byte sector per group of 8 slots holding one), and the
// (D, n_p) ring read and written once.  Reading every slot's col and
// weight instead (row_dot, 8 bytes a slot) needs 2.8-4.2 times the bytes:
// the remote sub-panels of a k=4 microcircuit partition hold 53,970,086
// real slots in 113,614,848, and almost every weight meets a silent
// source.
// Design: a persistent grid (as many 1024-thread blocks as fit on the
// card).  Each block first packs the activity into a bitmask in its own
// shared memory: its warps read act (written by an earlier launch; 77 KB
// for the local pass's (n_p,) vector, 308 KB for the remote pass's
// (n_global,) one, from L2 after the first block) and one __ballot_sync
// makes each word.  So the pass takes no extra launch: the k>1 paths are
// host-bound, and a pack launch per pass (spike_gather's design) would add
// two launches a partition and step to the host's loop, while the repeated
// pack costs each block a read of act from L2.  A bitmask that the exchange
// wrote (a third option) would tie the kernel to the exchange's layout.
// Then one warp per row r < n_p: for each bucket, row_dot_active
// (common.cuh) reads the row's first row_len[r] cols, tests each source's
// bit in shared memory, and only for a set bit loads the weight and
// act[c]; the sum parks in shared memory; then lane j updates ring slots
// j, j+32, ... of the row with the reference's formulation (ground rule (e)
// of ROADMAP.md):
//   x = ring[s][r] * clear[s];  then per bucket in order  x += onehot[b][s] * cur_b
// with every operation rounded on its own.  Each ring element is read and
// written by one thread, so the update may be in place (ring_out ==
// ring_in).  The currents equal row_dot's bit for bit (the argument, and
// its precondition of finite weights and activity, in common.cuh), so the
// ring is every other engine's.  An activity too long for the bitmask to
// fit shared memory (about 1.8 M ids) is tested in device memory directly
// (act != 0); no case falls back to the plain version.  The row_dot
// variant (dense != 0; the template flag kRowDot) is the same launch with
// row_dot over every slot and no bitmask: it runs for panels whose weights
// are not all finite or change (plastic panels; the caller's choice from
// the data, PartitionDeviceData.reduce), and it is the bit-exact oracle of
// the active variant on the card.
// Weights: f32 or bf16 panels (the template W, one type for every bucket of a
// launch, widened exactly by common.cuh:load_weight), summed in f32 as the
// reference's kernel does (fused_step.py:528, :716); the ring is f32.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxBuckets = 32;  // kernels/split_step.py:MAX_BUCKETS

struct PostArgs {
  const float* act;      // (n,) activity the panels' col ids index
  int n;
  int words;             // ceil(n / 32)
  const float* ring_in;  // (D, n_p)
  float* ring_out;       // (D, n_p), may alias ring_in
  const float* clear;    // (D,) or nullptr: no rotate (a clear of ones)
  const float* onehot;   // (nd, D)
  int n_p;
  int D;
  int nd;
  const int* cols[kMaxBuckets];
  const void* w[kMaxBuckets];  // f32 or bf16 (the kernel's W)
  const int* row_len[kMaxBuckets];  // (R,) real slots a row; null: K
  int K[kMaxBuckets];
};

// one block per SM: 64 registers a thread
template <bool kShared, bool kRowDot, class W>
__global__ void __launch_bounds__(kThreads, 1) post_exchange_kernel(const PostArgs a) {
  extern __shared__ uint32_t staged[];
  __shared__ float cur_s[kWarpsPerBlock][kMaxBuckets];
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (kShared && !kRowDot) {
    for (int word = wib; word < a.words; word += kWarpsPerBlock) {  // warp-uniform
      const int j = word * 32 + lane;
      const bool on = j < a.n && __ldg(a.act + j) != 0.0f;
      const uint32_t m = __ballot_sync(0xffffffffu, on);
      if (lane == 0) staged[word] = m;
    }
    __syncthreads();
  }
  float* cur = cur_s[wib];
  for (int r = blockIdx.x * kWarpsPerBlock + wib; r < a.n_p;
       r += gridDim.x * kWarpsPerBlock) {  // warp-uniform
    for (int b = 0; b < a.nd; ++b) {
      const int K = a.K[b];
      const size_t off = static_cast<size_t>(r) * K;
      const int* cols = a.cols[b] + off;
      const W* w = static_cast<const W*>(a.w[b]) + off;
      float c;
      if (kRowDot) {
        c = row_dot(cols, w, a.act, K, lane);
      } else {
        const int len = a.row_len[b] == nullptr ? K : min(__ldg(a.row_len[b] + r), K);
        c = kShared ? row_dot_active(cols, w, a.act, SharedBits{staged}, len, lane)
                    : row_dot_active(cols, w, a.act, ActBits{a.act}, len, lane);
      }
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
    __syncwarp();  // cur is rewritten by the warp's next row
  }
}

template <class W>
int launch(const PostArgs& a, int dense, bool shared, int device, void* stream) {
  const void* kernel =
      dense    ? reinterpret_cast<const void*>(post_exchange_kernel<false, true, W>)
      : shared ? reinterpret_cast<const void*>(post_exchange_kernel<true, false, W>)
               : reinterpret_cast<const void*>(post_exchange_kernel<false, false, W>);
  const size_t smem = shared ? 4 * static_cast<size_t>(a.words) : 0;
  int grid = 0;
  cudaError_t err = resident_blocks(kernel, device, kThreads, smem, &grid);
  if (err != cudaSuccess) return err;
  const int needed = (a.n_p + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (needed < grid) grid = needed;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dense) {
    post_exchange_kernel<false, true, W><<<grid, kThreads, 0, s>>>(a);
  } else if (shared) {
    post_exchange_kernel<true, false, W><<<grid, kThreads, smem, s>>>(a);
  } else {
    post_exchange_kernel<false, false, W><<<grid, kThreads, 0, s>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_post_exchange_max_buckets() { return kMaxBuckets; }

// row_len: per bucket a pointer to (R,) int32, or null for rows K long.
// smem_cap: the most bytes of shared memory the bitmask may take (< 0: the
// card's limit; 0: test act in device memory).  dense != 0: the row_dot
// variant (row_len and smem_cap unused).  w_bf16 != 0: every bucket's
// weights are bf16, else f32.
extern "C" int repro_post_exchange(const float* act, int n, const float* ring_in,
                                   float* ring_out, const float* clear,
                                   const float* onehot, int n_p, int D, int nd,
                                   const void* const* cols,
                                   const void* const* w, int w_bf16,
                                   const void* const* row_len, const int* K,
                                   int smem_cap, int dense, void* stream,
                                   int device) {
  if (nd < 1 || nd > kMaxBuckets || D < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  PostArgs a;
  a.act = act;
  a.n = n;
  a.words = (n + 31) / 32;
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
    a.w[b] = used ? w[b] : nullptr;
    a.row_len[b] = used ? static_cast<const int*>(row_len[b]) : nullptr;
    a.K[b] = used ? K[b] : 0;
  }
  bool shared = false;
  if (!dense) {
    err = bits_in_shared(device, a.words, smem_cap, &shared);
    if (err != cudaSuccess) return err;
  }
  if (w_bf16) return launch<__nv_bfloat16>(a, dense, shared, device, stream);
  return launch<float>(a, dense, shared, device, stream);
}
