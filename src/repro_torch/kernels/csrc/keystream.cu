// Threefry-2x32-20 keystream words for the procedural network builder.
//
// Replaces: src/repro/kernels/keystream.py:keystream_pallas (pallas_call at
// :58).  out[r, j] is word j0 + j of the stream keyed by (seed, stream) at
// counter rows[r]; word w is output half (w & 1) of the cipher applied to the
// counter pair (rows[r], w >> 1).  Bit-identical to the numpy oracle
// builder/crng.py:word_matrix: uint32 adds, xors and rotates only, whose
// wrap-around is defined.
//
// Bound on the H100: at the build's shapes the output bytes (8,192 x 11,136
// words, 365 MB: 0.109 ms at 3.35 TB/s) and the cipher's integer
// instructions (67 a cipher: 20 rotates, 20 xors, 27 adds) come out close.
// The design keeps every pipe's dispatch time under the bytes':
//   * a persistent grid, sized from the occupancy query, strides over work
//     items (row, group of G counter pairs), so no thread pays a block's
//     launch and retire, the key schedule or a row's set-up for one cipher;
//   * each item runs G ciphers interleaved (independent chains, for ILP) and
//     stores their 2G words with 16-byte stores where the row's alignment
//     allows: an item is interior unless it holds a row's first or last
//     word, and only the edges store word by word;
//   * the first rotate of each four-round block takes the multiply form of
//     threefry.cuh (IMAD.WIDE.U32 on the FMA pipe, the OR folded into the
//     xor's LOP3), so that the ALU pipe (the other rotates, the xors, some
//     adds) and the FMA pipe (the products, most adds) carry about equal
//     loads; G and this split were chosen on the card, from the time and
//     the SASS of each;
//   * index arithmetic within a row is 32-bit (word w of a row, counted
//     from j0 rounded down to even); only the row base is 64-bit, and the
//     item's (row, group) advances by the grid's stride without a division.
// chip_smoke.py (keystream_sass, keystream_bound) reads the loop's
// instructions by pipe from the built library's SASS.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 4;  // G: counter pairs (ciphers) a work item
static_assert(kPairs % 2 == 0, "an item's words go out as 16-byte stores of two pairs");

struct KeystreamArgs {
  int64_t n_items;      // n_rows * n_groups
  int64_t n_words;      // words a row
  uint32_t n_groups;    // work items a row: ceil(pairs / kPairs)
  uint32_t k0, k1;      // the key (seed, stream)
  uint32_t p0;          // the first counter pair, j0 >> 1
  uint32_t odd;         // j0 & 1: the first pair's even word is not stored
  uint32_t step_rows;   // the grid's stride in items = step_rows * n_groups
  uint32_t step_groups; //                              + step_groups
};

template <int G>
__device__ __forceinline__ void store_words(uint32_t* __restrict__ row,
                                            uint32_t w0, uint32_t odd,
                                            uint32_t end, const uint32_t (&x0)[G],
                                            const uint32_t (&x1)[G]) {
  // word w of the item sits at row[w - odd]; the row holds w in [odd, end)
  if (w0 >= odd && w0 + 2 * G <= end) {
    uint32_t* dst = row + (w0 - odd);
    const uintptr_t at = reinterpret_cast<uintptr_t>(dst);
    if ((at & 15) == 0) {
#pragma unroll
      for (int g = 0; g < G; g += 2) {
        *reinterpret_cast<uint4*>(dst + 2 * g) = make_uint4(x0[g], x1[g], x0[g + 1], x1[g + 1]);
      }
    } else if ((at & 7) == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        *reinterpret_cast<uint2*>(dst + 2 * g) = make_uint2(x0[g], x1[g]);
      }
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        dst[2 * g] = x0[g];
        dst[2 * g + 1] = x1[g];
      }
    }
    return;
  }
  // a row's first or last item: only the words inside the row
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint32_t w = w0 + 2 * g;
    if (w >= odd && w < end) row[w - odd] = x0[g];
    if (w + 1 < end) row[w + 1 - odd] = x1[g];
  }
}

__global__ void __launch_bounds__(kThreads)
    keystream_kernel(const int64_t* __restrict__ rows, uint32_t* __restrict__ out,
                     KeystreamArgs a, ThreefryMul mul) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= a.n_items) return;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  uint32_t iters = static_cast<uint32_t>((a.n_items - 1 - tid) / stride) + 1;
  int64_t r = tid / a.n_groups;
  uint32_t g = static_cast<uint32_t>(tid - r * a.n_groups);
  const uint32_t k2 = threefry_parity(a.k0, a.k1);
  const uint32_t end = static_cast<uint32_t>(a.n_words) + a.odd;
#pragma unroll 1
  for (; iters != 0; --iters) {
    const uint32_t c0 = static_cast<uint32_t>(rows[r]);
    const uint32_t pair = a.p0 + g * kPairs;
    uint32_t x0[kPairs], x1[kPairs];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      x0[i] = c0;
      x1[i] = pair + i;
    }
    threefry2x32_20_g<kPairs>(a.k0, a.k1, k2, x0, x1, mul);
    store_words<kPairs>(out + r * a.n_words, 2 * kPairs * g, a.odd, end, x0, x1);
    g += a.step_groups;
    r += a.step_rows;
    if (g >= a.n_groups) {
      g -= a.n_groups;
      ++r;
    }
  }
}

}  // namespace

// rows: (n_rows,) int64 counters in [0, 2^32), checked by the wrapper;
// out: (n_rows, n_words) 32-bit words, contiguous; j0 + n_words <= 2^32 and
// n_words < 2^31.
extern "C" int repro_keystream(const int64_t* rows, uint32_t* out,
                               int64_t n_rows, int n_words, uint32_t seed,
                               uint32_t stream_id, uint32_t j0, void* stream,
                               int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_rows <= 0 || n_words <= 0) return cudaSuccess;
  const int64_t n_pairs =
      ((static_cast<int64_t>(j0) + n_words - 1) >> 1) - (j0 >> 1) + 1;
  const int64_t n_groups = (n_pairs + kPairs - 1) / kPairs;
  const int64_t n_items = n_rows * n_groups;
  int resident = 0;
  err = resident_blocks(reinterpret_cast<const void*>(keystream_kernel), device,
                        kThreads, 0, &resident);
  if (err != cudaSuccess) return err;
  const int64_t blocks =
      std::min<int64_t>(resident, (n_items + kThreads - 1) / kThreads);
  const int64_t step = blocks * kThreads;
  KeystreamArgs a;
  a.n_items = n_items;
  a.n_words = n_words;
  a.n_groups = static_cast<uint32_t>(n_groups);
  a.k0 = seed;
  a.k1 = stream_id;
  a.p0 = j0 >> 1;
  a.odd = j0 & 1;
  a.step_rows = static_cast<uint32_t>(step / n_groups);
  a.step_groups = static_cast<uint32_t>(step % n_groups);
  keystream_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(rows, out, a, threefry_mul());
  return cudaGetLastError();
}
