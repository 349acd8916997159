// Threefry-2x32-20 (Salmon et al., SC'11), shared by keystream.cu (the
// procedural builder's words) and noise.cu (the simulator's per-step noise).
// uint32 adds, xors and rotates only, whose wrap-around is defined, so the
// words equal the numpy oracle (builder/crng.py:threefry2x32) and the plain
// torch version (kernels/ref.py:threefry2x32_ref) bit for bit.
//
// The instruction form, for the H100's pipes.  Each of the 20 rounds is an
// add, a rotate and a xor.  A funnel-shift rotate (SHF.L.W) and a xor (LOP3)
// run only on the ALU pipe, which dispatches half a warp instruction a clock and
// SM sub-partition; the adds may dispatch as IMAD.IADD on the FMA pipe beside it.
// So a rotate may instead take the multiply form: rotl(x, r) is the OR of the
// two halves of the 64-bit product x * 2^r, one IMAD.WIDE.U32 on the FMA
// pipe, and the OR folds with the round's xor into one three-input LOP3.  The
// multiplier comes from a kernel argument (ThreefryMul), never a literal, so
// that the compiler cannot turn the product back into shifts.  kWideRotates
// picks, per rotate, which form it takes; chip_smoke.py:keystream_sass reads
// the resulting instructions by pipe from the built library.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr uint32_t kThreefryC240 = 0x1BD11BDAu;  // Threefry's key-schedule parity

// The rotation constants: rounds of even four-round blocks take slots 0-3,
// odd blocks slots 4-7.
__host__ __device__ constexpr int threefry_rot(int slot) {
  return slot == 0 ? 13 : slot == 1 ? 15 : slot == 2 ? 26 : slot == 3 ? 6
       : slot == 4 ? 17 : slot == 5 ? 29 : slot == 6 ? 16 : 24;
}

// Bit j set: the cipher's rotate j (round j, 0..19) takes the multiply form.
// The first rotate of each four-round block: chosen on the card from the
// SASS, with IMAD.WIDE taking two dispatch slots of the FMA pipe (it writes a
// register pair), so that the ALU and the FMA pipe carry about equal loads.
constexpr uint32_t kWideRotates = 0x11111u;

// 2^r for each rotation constant, passed to a kernel by value.
struct ThreefryMul {
  uint32_t m[8];
};

static inline ThreefryMul threefry_mul() {
  ThreefryMul mul;
  for (int i = 0; i < 8; ++i) mul.m[i] = 1u << threefry_rot(i);
  return mul;
}

// The third key word of the schedule ks = (k0, k1, k0 ^ k1 ^ C240).
__device__ __forceinline__ uint32_t threefry_parity(uint32_t k0, uint32_t k1) {
  return k0 ^ k1 ^ kThreefryC240;
}

// rotl(x1, r) ^ x0 for the cipher's rotate J.
template <int J>
__device__ __forceinline__ uint32_t rotl_xor(uint32_t x1, uint32_t x0,
                                             const ThreefryMul& mul) {
  constexpr int slot = (J / 4) % 2 * 4 + J % 4;
  if constexpr ((kWideRotates >> J) & 1u) {
    // the product's halves straight from the register pair: written in C++,
    // the compiler adds a zero to the high half (one more instruction)
    uint32_t lo, hi;
    asm("{\n\t.reg .u64 p;\n\tmul.wide.u32 p, %2, %3;\n\tmov.b64 {%0, %1}, p;\n\t}"
        : "=r"(lo), "=r"(hi)
        : "r"(x1), "r"(mul.m[slot]));
    return (lo | hi) ^ x0;
  } else {
    return __funnelshift_l(x1, x1, threefry_rot(slot)) ^ x0;
  }
}

// Round J of G independent ciphers, interleaved for instruction-level
// parallelism.
template <int J, int G>
__device__ __forceinline__ void round_g(uint32_t (&x0)[G], uint32_t (&x1)[G],
                                        const ThreefryMul& mul) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    x0[g] += x1[g];
    x1[g] = rotl_xor<J>(x1[g], x0[g], mul);
  }
}

// Block B of four rounds, then the key injection: x0 += ks[(B+1) % 3],
// x1 += ks[(B+2) % 3] + B + 1.
template <int B, int G>
__device__ __forceinline__ void block_g(uint32_t (&x0)[G], uint32_t (&x1)[G],
                                        const uint32_t (&ks)[3],
                                        const ThreefryMul& mul) {
  round_g<4 * B, G>(x0, x1, mul);
  round_g<4 * B + 1, G>(x0, x1, mul);
  round_g<4 * B + 2, G>(x0, x1, mul);
  round_g<4 * B + 3, G>(x0, x1, mul);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    x0[g] += ks[(B + 1) % 3];
    x1[g] += ks[(B + 2) % 3] + static_cast<uint32_t>(B + 1);
  }
}

// Threefry-2x32-20 of G counter pairs (x0[g], x1[g]) under the key (k0, k1),
// in place: on return x0 and x1 hold the output words.
template <int G>
__device__ __forceinline__ void threefry2x32_20_g(uint32_t k0, uint32_t k1,
                                                  uint32_t k2, uint32_t (&x0)[G],
                                                  uint32_t (&x1)[G],
                                                  const ThreefryMul& mul) {
  const uint32_t ks[3] = {k0, k1, k2};
#pragma unroll
  for (int g = 0; g < G; ++g) {
    x0[g] += k0;
    x1[g] += k1;
  }
  block_g<0, G>(x0, x1, ks, mul);
  block_g<1, G>(x0, x1, ks, mul);
  block_g<2, G>(x0, x1, ks, mul);
  block_g<3, G>(x0, x1, ks, mul);
  block_g<4, G>(x0, x1, ks, mul);
}

// One cipher: the counter pair (c0, c1) under the key (k0, k1), with
// k2 = threefry_parity(k0, k1).
__device__ __forceinline__ void threefry2x32_20(uint32_t k0, uint32_t k1,
                                                uint32_t k2, uint32_t c0,
                                                uint32_t c1, const ThreefryMul& mul,
                                                uint32_t& o0, uint32_t& o1) {
  uint32_t x0[1] = {c0};
  uint32_t x1[1] = {c1};
  threefry2x32_20_g<1>(k0, k1, k2, x0, x1, mul);
  o0 = x0[0];
  o1 = x1[0];
}
