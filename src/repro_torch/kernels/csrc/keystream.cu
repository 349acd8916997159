// Threefry-2x32-20 keystream words for the procedural network builder.
//
// Replaces: src/repro/kernels/keystream.py:keystream_pallas (pallas_call at
// :58).  out[r, j] is word j0 + j of the stream keyed by (seed, stream) at
// counter rows[r]; word w is output half (w & 1) of the cipher applied to the
// counter pair (rows[r], w >> 1).  Bit-identical to the numpy oracle
// builder/crng.py:word_matrix: uint32 adds, xors and rotates only, whose
// wrap-around is defined.
//
// Design: one thread per (row, counter pair).  The TPU kernel runs the whole
// cipher for every output word and keeps one half, so that the VPU sees a
// pure elementwise map; here a thread runs the cipher once and stores both
// halves, half the integer work.  The edges: with an odd j0 the first pair of
// a row contributes only its odd half, and with an odd tail the last pair
// only its even half.  Rows are arbitrary counters (gathered source ids, with
// repeats, in any order), so each thread reads rows[r].
//
// Block shape: bx threads along the pairs of a row (the least power of two
// >= the pairs, at most 256) times 256 / bx rows, so a call of one or two
// words a row (the degree and vertex streams) keeps its lanes busy without a
// division per thread.  The grid covers the pairs in x and strides over the
// rows in y.  A warp's stores along one row are 64 consecutive words; an
// aligned pair is one 8-byte store.
//
// Bound on the H100: the cipher's ALU-pipe instructions and the output bytes
// come out nearly equal; chip_smoke.py (keystream_bound, keystream_sass)
// derives the instruction count and reads this kernel's SASS per pipe.  The
// row loop is kept rolled so that its body holds exactly one cipher.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
    keystream_kernel(const int64_t* __restrict__ rows,
                     uint32_t* __restrict__ out, int64_t n_rows, int n_words,
                     uint32_t k0, uint32_t k1, uint32_t j0, int64_t n_pairs) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= n_pairs) return;
  const uint32_t k2 = threefry_parity(k0, k1);
  const uint32_t pair = (j0 >> 1) + static_cast<uint32_t>(q);
  // output columns of the pair's even and odd word: c_even is -1 when the
  // call starts at an odd j0, and c_even + 1 == n_words at an odd tail
  const int64_t c_even = 2 * static_cast<int64_t>(pair) - j0;
  const bool even_in = c_even >= 0;
  const bool odd_in = c_even + 1 < n_words;
  const int64_t stride = static_cast<int64_t>(gridDim.y) * blockDim.y;
#pragma unroll 1
  for (int64_t r = static_cast<int64_t>(blockIdx.y) * blockDim.y + threadIdx.y;
       r < n_rows; r += stride) {
    uint32_t o0, o1;
    threefry2x32_20(k0, k1, k2, static_cast<uint32_t>(rows[r]), pair, o0, o1);
    const int64_t at = r * n_words + c_even;  // 64-bit: R * n_words passes 2^31
    if (even_in && odd_in && (at & 1) == 0) {
      *reinterpret_cast<uint2*>(out + at) = make_uint2(o0, o1);
    } else {
      if (even_in) out[at] = o0;
      if (odd_in) out[at + 1] = o1;
    }
  }
}

}  // namespace

// rows: (n_rows,) int64 counters in [0, 2^32), checked by the wrapper;
// out: (n_rows, n_words) 32-bit words, contiguous and 8-byte aligned.
extern "C" int repro_keystream(const int64_t* rows, uint32_t* out,
                               int64_t n_rows, int n_words, uint32_t seed,
                               uint32_t stream_id, uint32_t j0, void* stream,
                               int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_rows <= 0 || n_words <= 0) return cudaSuccess;
  const int64_t n_pairs =
      ((static_cast<int64_t>(j0) + n_words - 1) >> 1) - (j0 >> 1) + 1;
  int bx = 1;
  while (bx < n_pairs && bx < kThreads) bx *= 2;
  const int by = kThreads / bx;
  const int64_t gx = (n_pairs + bx - 1) / bx;
  int64_t gy = (n_rows + by - 1) / by;
  if (gy > kMaxGridY) gy = kMaxGridY;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  const dim3 block(bx, by);
  keystream_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, out, n_rows, n_words, seed, stream_id, j0, n_pairs);
  return cudaGetLastError();
}
