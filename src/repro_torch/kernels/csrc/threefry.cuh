// Threefry-2x32-20 (Salmon et al., SC'11), shared by keystream.cu (the
// procedural builder's words) and noise.cu (the simulator's per-step noise).
// uint32 adds, xors and rotates only, whose wrap-around is defined, so the
// words equal the numpy oracle (builder/crng.py:threefry2x32) and the plain
// torch version (kernels/ref.py:threefry2x32_ref) bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr uint32_t kThreefryC240 = 0x1BD11BDAu;  // Threefry's key-schedule parity

// The third key word of the schedule ks = (k0, k1, k0 ^ k1 ^ C240).
__device__ __forceinline__ uint32_t threefry_parity(uint32_t k0, uint32_t k1) {
  return k0 ^ k1 ^ kThreefryC240;
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = rotl(x1, R0) ^ x0;
  x0 += x1;
  x1 = rotl(x1, R1) ^ x0;
  x0 += x1;
  x1 = rotl(x1, R2) ^ x0;
  x0 += x1;
  x1 = rotl(x1, R3) ^ x0;
}

// Threefry-2x32-20 with the key schedule ks = (k0, k1, k0 ^ k1 ^ C240):
// after block i of four rounds, x0 += ks[(i+1) % 3], x1 += ks[(i+2) % 3] + i+1.
__device__ __forceinline__ void threefry2x32_20(uint32_t k0, uint32_t k1,
                                                uint32_t k2, uint32_t c0,
                                                uint32_t c1, uint32_t& o0,
                                                uint32_t& o1) {
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
  o0 = x0;
  o1 = x1;
}
