"""Counter-based RNG for procedural network construction.

A copy of ``repro/builder/crng.py`` kept in the port, which imports nothing
of the JAX package.  Every random draw made by the builder is a pure
function of ``(seed, stream, row, draw)`` -- no sequential generator state --
so any partition, any chunk size, and either sampling path reproduce the
exact same network bit-for-bit ("construct where it lives",
arXiv:2512.09502).

The primitive is Threefry-2x32 with 20 rounds.  The numpy version here is
the oracle; the device path computes the same words with the CUDA kernel
``kernels/csrc/keystream.cu`` (on the CPU: its plain torch version,
``kernels/keystream.py:keystream_plain``).  The whole keystream is uint32
arithmetic (adds, xors, rotates), so all three agree word-for-word.

Bit-identity across paths is preserved by a hard rule: *device code only
ever produces uint32 keystream words*.  All floating-point assembly (uniform
conversion, affine weight transforms, distance kernels) happens host-side in
the shared numpy code below, so no FMA contraction or transcendental
function can make the paths diverge.

Normals are drawn fixed-point: the sum of ``NORMAL_WORDS`` 24-bit
uniforms minus the mean, an exact int32 quantity, scaled by a single
float32 constant.  (Irwin-Hall: variance ``NORMAL_WORDS/12`` before
rescaling.)
"""

from __future__ import annotations

import numpy as np

# Threefry-2x32 constants (Salmon et al., SC'11).
_C240 = 0x1BD11BDA
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)

# Stream-id layout.  Vertex-level streams are fixed; connectivity rules
# get a block of RULE_STRIDE streams each starting at STREAM_RULE0, so a
# spec supports (2**32 - STREAM_RULE0) / RULE_STRIDE rules.
STREAM_V = 0
STREAM_BIAS = 1
STREAM_COORD = 2
STREAM_RULE0 = 16
RULE_STRIDE = 8
DEGREE_OFF = 0
SRC_OFF = 1
ACCEPT_OFF = 2
WEIGHT_OFF = 3
DELAY_OFF = 4

# Words of 24-bit uniform summed per normal draw (Irwin-Hall).
NORMAL_WORDS = 4
# Rescale so the fixed-point sum has unit variance: the int32 sum of
# NORMAL_WORDS u24 draws minus the mean has variance (NORMAL_WORDS/12) * 2**48,
# so z = fixed * 2**-24 * sqrt(12/NORMAL_WORDS).
NORMAL_SCALE = np.float32(2.0**-24 * (12.0 / NORMAL_WORDS) ** 0.5)

U24_SCALE = np.float32(2.0**-24)


def rule_stream(rule_index: int, field: int) -> int:
    """Stream id for ``field`` (one of the ``*_OFF`` constants) of rule ``rule_index``."""
    return STREAM_RULE0 + RULE_STRIDE * int(rule_index) + int(field)


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32-20 block cipher.  All inputs uint32, broadcastable.

    Returns the two output words ``(x0, x1)`` as uint32 arrays.
    """
    u32 = np.uint32
    k0 = np.asarray(k0, u32)
    k1 = np.asarray(k1, u32)
    ks = (k0, k1, k0 ^ k1 ^ np.asarray(_C240, u32))
    x0 = np.asarray(c0, u32) + ks[0]
    x1 = np.asarray(c1, u32) + ks[1]
    for i in range(5):
        rots = _ROT_A if i % 2 == 0 else _ROT_B
        for r in rots:
            x0 = x0 + x1
            x1 = ((x1 << u32(r)) | (x1 >> u32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.asarray(i + 1, u32)
    return x0, x1


def word_matrix(seed, stream, rows, j0, n_words):
    """Keystream words for a block of rows.

    Returns a ``(len(rows), n_words)`` uint32 matrix where column ``j``
    holds word ``j0 + j`` of the stream keyed by ``(seed, stream)`` at
    counter ``row``.  Word ``w`` is output half ``w % 2`` of the cipher
    applied at counter ``(row, w // 2)`` — so the matrix is independent
    of how rows and words are chunked across calls.
    """
    u32 = np.uint32
    rows = np.asarray(rows, u32).reshape(-1, 1)
    j = np.asarray(j0, u32) + np.arange(n_words, dtype=u32).reshape(1, -1)
    pair = j >> u32(1)
    parity = j & u32(1)
    x0, x1 = threefry2x32(seed, stream, rows, pair)
    return np.where(parity == 0, x0, x1)


def mulhi32(a, b):
    """High 32 bits of the 32x32->64 product, using only uint32 ops.

    Split both operands into 16-bit halves; every partial sum below is
    provably < 2**32 so nothing overflows.
    """
    u32 = np.uint32
    a = np.asarray(a, u32)
    b = np.asarray(b, u32)
    mask = u32(0xFFFF)
    a_lo, a_hi = a & mask, a >> u32(16)
    b_lo, b_hi = b & mask, b >> u32(16)
    lo_lo = a_lo * b_lo
    mid1 = a_hi * b_lo
    mid2 = a_lo * b_hi
    # carry from the low 32 bits of the full product
    t = (lo_lo >> u32(16)) + (mid1 & mask) + (mid2 & mask)
    return a_hi * b_hi + (mid1 >> u32(16)) + (mid2 >> u32(16)) + (t >> u32(16))


def uint_below(words, bound):
    """Map uint32 keystream words to integers in ``[0, bound)``.

    Uses the multiply-shift reduction (Lemire); bias is < 2**-32 * bound,
    negligible for network construction, and — crucially — it is a pure
    function of the word, so every backend agrees.
    """
    return mulhi32(words, np.asarray(bound, np.uint32))


# ---------------------------------------------------------------------------
# Host-side float assembly (NumPy only — shared by ref and device paths).
# ---------------------------------------------------------------------------


def u24(words):
    """Top 24 bits of each word as uint32 (exactly representable in f32)."""
    return np.asarray(words, np.uint32) >> np.uint32(8)


def uniform01(words):
    """Words -> float32 uniforms in [0, 1) with 24-bit resolution."""
    return u24(words).astype(np.float32) * U24_SCALE


def normal_fixed(words):
    """Fixed-point standard-normal-ish draws from Irwin-Hall sums.

    ``words`` has shape ``(..., NORMAL_WORDS)``; returns int32 of the
    same leading shape: ``sum(u24) - NORMAL_WORDS * 2**23`` (zero-mean,
    exact integer arithmetic).
    """
    s = u24(words).astype(np.int64).sum(axis=-1)
    s -= NORMAL_WORDS * (1 << 23)
    return s.astype(np.int32)


def standard_normal(words):
    """float32 unit-variance draws from ``normal_fixed`` words."""
    return normal_fixed(words).astype(np.float32) * NORMAL_SCALE
