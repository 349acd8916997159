// ELL gather-accumulate: cur[r] = sum_k w[r,k] * act[cols[r,k]], one warp per
// row, reading only the real slots and only the weights of active sources.
//
// Replaces: src/repro/kernels/spike_gather.py:spike_gather_pallas
// (pallas_call at :65), which keeps the whole activity vector resident in
// VMEM and streams (block_r, block_k) col/weight panels past it.
// Bound on the H100: HBM bytes, and only the bytes that carry information:
// the col of every real slot (4 bytes) and the weight of every slot whose
// source is active.  Reading every padded slot's col and weight, as the
// dense kernels do, costs 8 bytes a slot; on the microcircuit 45% of the
// slots are padding and more than 99% of the real weights meet a silent
// source, so those bytes would be three quarters of the traffic.
// Design, two launches on the caller's stream:
//   1. pack: one warp per 32 ids packs the activity into a bitmask with
//      __ballot_sync (bit set iff act != 0; 9.6 KB for 77,172 ids);
//   2. gather: a persistent grid (as many blocks as fit on the card) whose
//      blocks each copy the bitmask into dynamic shared memory, then walk
//      rows warp by warp: row_dot_active (common.cuh) reads the row's first
//      row_len[r] cols, tests each source's bit in shared memory, and only
//      for a set bit loads the weight and act[c].  A bitmask larger than the
//      card's shared memory per block (about 1.8 M ids) is read from device
//      memory through the read-only path instead; no case falls back to the
//      plain version.
// The result equals the dense row_dot's bit for bit (the argument and its
// precondition, finite weights and activity, are in common.cuh).  row_len
// may be null: every row is then K long.  No atomics, so the result does
// not depend on scheduling.
// The row_dot variant (dense != 0; the template flag kRowDot) is the same
// gather launch with row_dot over every slot of every row and no pack
// launch: it runs for a panel whose weights are not all finite or change
// (the caller's choice from the data), where a NaN weight of a silent
// source must give the reference's NaN, and it is the bit-exact oracle of
// the active variant on the card.
// The heavy-row split's virtual rows, with their segment sums and the ring
// add, are segment_gather.cu's one launch a step.
#include "common.cuh"

namespace {

constexpr int kPackThreads = 256;
constexpr int kThreads = 1024;
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kPackThreads)
    pack_kernel(const float* act, int n, uint32_t* bits, int words) {
  const int word = (blockIdx.x * kPackThreads + threadIdx.x) >> 5;
  if (word >= words) return;  // warp-uniform
  pack_active_bits(act, n, bits, word, threadIdx.x & 31);
}

// One row's reduction.
template <bool kShared, bool kRowDot, class W>
__device__ __forceinline__ float gather_row(const float* act, const int* cols, const W* w,
                                            const int* row_len, const uint32_t* bits,
                                            const uint32_t* staged, int row, int K, int lane) {
  const size_t off = static_cast<size_t>(row) * K;
  if (kRowDot) return row_dot(cols + off, w + off, act, K, lane);
  const int len = row_len == nullptr ? K : min(__ldg(row_len + row), K);
  return kShared ? row_dot_active(cols + off, w + off, act, SharedBits{staged}, len, lane)
                 : row_dot_active(cols + off, w + off, act, LdgBits{bits}, len, lane);
}

template <bool kShared, bool kRowDot, class W>
__global__ void __launch_bounds__(kThreads, 1)
    spike_gather_kernel(const float* act, const int* cols, const W* w, const int* row_len,
                        const uint32_t* bits, int words, float* __restrict__ out, int R, int K) {
  extern __shared__ uint32_t staged[];
  if (kShared && !kRowDot) {
    for (int i = threadIdx.x; i < words; i += kThreads) staged[i] = __ldg(bits + i);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int nwarps = gridDim.x * kWarpsPerBlock;
  for (int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); row < R; row += nwarps) {
    const float s =
        gather_row<kShared, kRowDot>(act, cols, w, row_len, bits, staged, row, K, lane);
    if (lane == 0) out[row] = s;
  }
}

template <bool kShared, bool kRowDot, class W>
cudaError_t launch(const float* act, const int* cols, const void* w, const int* row_len,
                   const uint32_t* bits, int words, float* out, int R, int K, cudaStream_t s,
                   int device) {
  const auto kernel = spike_gather_kernel<kShared, kRowDot, W>;
  const size_t smem = kShared && !kRowDot ? 4 * static_cast<size_t>(words) : 0;
  int grid = 0;
  cudaError_t err = resident_blocks(reinterpret_cast<const void*>(kernel), device, kThreads,
                                    smem, &grid);
  if (err != cudaSuccess) return err;
  const int needed = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (needed < grid) grid = needed;
  kernel<<<grid, kThreads, smem, s>>>(act, cols, static_cast<const W*>(w), row_len, bits, words,
                                      out, R, K);
  return cudaGetLastError();
}

template <bool kShared, bool kRowDot>
cudaError_t launch_w(int w_bf16, const float* act, const int* cols, const void* w,
                     const int* row_len, const uint32_t* bits, int words, float* out, int R,
                     int K, cudaStream_t s, int device) {
  return w_bf16 ? launch<kShared, kRowDot, __nv_bfloat16>(act, cols, w, row_len, bits, words,
                                                           out, R, K, s, device)
                : launch<kShared, kRowDot, float>(act, cols, w, row_len, bits, words, out, R,
                                                  K, s, device);
}

}  // namespace

// w: an (R, K) panel of f32 (w_bf16 == 0) or bf16 weights.  bits: scratch
// of ceil(n / 32) words.  smem_cap: the most bytes of shared memory the
// bitmask may take (< 0: the card's limit; 0: read it from device memory).
// dense != 0: the row_dot variant (bits, row_len and smem_cap unused).
extern "C" int repro_spike_gather(const float* act, int n, const int* cols, const void* w,
                                  int w_bf16, const int* row_len, uint32_t* bits, float* out,
                                  int R, int K, int smem_cap, int dense, void* stream,
                                  int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (n + 31) / 32;
  if (dense)
    return launch_w<false, true>(w_bf16, act, cols, w, row_len, bits, 0, out, R, K, s, device);
  if (words > 0) {
    pack_kernel<<<(words * 32 + kPackThreads - 1) / kPackThreads, kPackThreads, 0, s>>>(
        act, n, bits, words);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  bool shared = false;
  err = bits_in_shared(device, words, smem_cap, &shared);
  if (err != cudaSuccess) return err;
  if (shared)
    return launch_w<true, false>(w_bf16, act, cols, w, row_len, bits, words, out, R, K, s,
                                 device);
  return launch_w<false, false>(w_bf16, act, cols, w, row_len, bits, words, out, R, K, s,
                                device);
}
