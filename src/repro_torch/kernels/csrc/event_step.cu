// Event-driven post-exchange step in one cooperative launch: compress the
// activity vector to spike ids, flag the row blocks those ids touch, then
// clear the delivered ring slot and gather-accumulate only the flagged rows
// of every delay bucket into the ring.  At k=1 the activity is the
// partition's own spike vector; in the split engine (fused_split_event) it is
// the exchanged (n_global,) vector while the ring has the partition's n_p
// rows, and the overlap mode's remote pass runs with no clear (slot < 0), as
// the reference passes a clear mask of ones there
// (src/repro/snn/simulator.py:370-376, :608-614).
//
// Replaces: src/repro/kernels/event_step.py:event_post_exchange_pallas
// (pallas_call at :198, body _make_event_kernel:135), together with the
// event_select compaction (:102) that the reference runs as jnp ops before
// it.  The TPU kernel skips an unflagged block by repeating the previous
// block index in a scalar-prefetch index map, so Pallas skips the HBM fetch.
// CUDA has no such fetch to skip: here a warp reads a block's flag and does
// not touch its panel rows at all.
// Bound on the H100: HBM bytes.  The flagged rows' col and weight slots (8
// bytes a slot, one fma) dominate; the compaction reads the (n,) spike
// vector once and the flag phase reads one touch byte per (block, spike id).
// Design, three phases separated by grid.sync():
//   1. grid-stride over the spike vector: each spiking neuron takes a slot
//      of the id buffer with atomicAdd on a counter the host zeroed; the
//      same loop clears the delivered ring slot.  The ids land in no fixed
//      order, but only their set is used: a block's flag is an OR over the
//      ids, and more ids than the buffer holds flags every block (the
//      reference's in-step dense fallback), so the result is deterministic;
//   2. one thread block per (bucket, row block) pair ORs the touch bytes of
//      the ids (__syncthreads_or) and writes the flag;
//   3. the (bucket, row) walk of fused_step.cu, one warp per row and the
//      same row_dot, skipping rows whose block is not flagged; lane 0 adds
//      the row's sum to its ring slot, bucket by bucket in order, so the
//      ring is bit-identical to the dense engines' on flagged rows, and
//      unflagged rows (whose dense sum is a signed zero) keep their value.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBuckets = 32;  // kernels/event_step.py:MAX_BUCKETS

struct EventArgs {
  const float* act;  // (n,) spike vector, 0/1 floats
  int n;
  const uint8_t* touch;  // (nd, nb, n): 1 iff id j has a valid slot in block
  int* ids;              // (cap,) id buffer
  int* count;            // spikes this step; zeroed by the host
  int cap;
  int* flags;   // (nd, nb) out
  float* ring;  // (D, n_p), updated in place
  int n_p;
  int slot;  // ring slot delivered this step (cleared here); < 0: no clear
  int nb;
  int block_r;
  int nd;
  const int* cols[kMaxBuckets];
  const float* w[kMaxBuckets];
  int K[kMaxBuckets];
  int wslot[kMaxBuckets];  // (t + d_b) % D
};

__global__ void __launch_bounds__(kThreads) event_step_kernel(const EventArgs a) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  float* ring_slot = a.ring + static_cast<size_t>(a.slot < 0 ? 0 : a.slot) * a.n_p;
  for (int j = tid; j < a.n; j += nthreads) {
    if (a.act[j] > 0.0f) {
      const int pos = atomicAdd(a.count, 1);
      if (pos < a.cap) a.ids[pos] = j;
    }
  }
  if (a.slot >= 0) {
    for (int r = tid; r < a.n_p; r += nthreads) ring_slot[r] = 0.0f;
  }
  cg::grid_group grid = cg::this_grid();
  grid.sync();

  // the counter and the ids were written by other blocks in this launch:
  // read them from L2 (ld.cg), never from a stale L1 line
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

  const int lane = threadIdx.x & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  for (int b = 0; b < a.nd; ++b) {
    const int K = a.K[b];
    const int* cols = a.cols[b];
    const float* w = a.w[b];
    const int* flags = a.flags + static_cast<size_t>(b) * a.nb;
    float* ring_w = a.ring + static_cast<size_t>(a.wslot[b]) * a.n_p;
    for (int r = warp; r < a.n_p; r += nwarps) {
      if (!__ldcg(flags + r / a.block_r)) continue;  // warp-uniform
      const size_t off = static_cast<size_t>(r) * K;
      const float s = row_dot(cols + off, w + off, a.act, K, lane);
      if (lane == 0) ring_w[r] = __fadd_rn(ring_w[r], s);
    }
  }
}

int co_resident_blocks(int device, int* blocks) {
  static int cached[64] = {0};
  if (device >= 0 && device < 64 && cached[device] > 0) {
    *blocks = cached[device];
    return cudaSuccess;
  }
  int sms = 0;
  int per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, event_step_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = sms * per_sm;
  if (device >= 0 && device < 64) cached[device] = *blocks;
  return cudaSuccess;
}

}  // namespace

extern "C" int repro_event_step_max_buckets() { return kMaxBuckets; }

extern "C" int repro_event_step(const float* act, int n, const uint8_t* touch,
                                int* ids, int* count, int cap, int* flags,
                                float* ring, int n_p, int slot, int nb,
                                int block_r, int nd, const void* const* cols,
                                const void* const* w, const int* K,
                                const int* wslot, void* stream, int device) {
  if (nd < 1 || nd > kMaxBuckets || block_r < 1 || cap < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  EventArgs a;
  a.act = act;
  a.n = n;
  a.touch = touch;
  a.ids = ids;
  a.count = count;
  a.cap = cap;
  a.flags = flags;
  a.ring = ring;
  a.n_p = n_p;
  a.slot = slot;
  a.nb = nb;
  a.block_r = block_r;
  a.nd = nd;
  for (int b = 0; b < kMaxBuckets; ++b) {
    const bool used = b < nd;
    a.cols[b] = used ? static_cast<const int*>(cols[b]) : nullptr;
    a.w[b] = used ? static_cast<const float*>(w[b]) : nullptr;
    a.K[b] = used ? K[b] : 0;
    a.wslot[b] = used ? wslot[b] : 0;
  }
  int grid = 0;
  err = static_cast<cudaError_t>(co_resident_blocks(device, &grid));
  if (err != cudaSuccess) return err;
  // no more blocks than the largest phase has work for
  const long long scan_blocks = ((n > n_p ? n : n_p) + kThreads - 1) / kThreads;
  const long long flag_blocks = static_cast<long long>(nd) * nb;
  const long long row_blocks =
      (static_cast<long long>(n_p) * 32 + kThreads - 1) / kThreads;
  long long work = scan_blocks > flag_blocks ? scan_blocks : flag_blocks;
  if (row_blocks > work) work = row_blocks;
  if (work < grid) grid = static_cast<int>(work > 0 ? work : 1);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(event_step_kernel),
                                    dim3(grid), dim3(kThreads), args, 0, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
