// The heavy-row split's step (SimConfig(max_k=...)) in one cooperative
// launch: every delay bucket's gather over its virtual rows, each real row's
// virtual rows added in ascending order, and the sums added into the ring.
//
// Replaces: src/repro/kernels/spike_gather.py:spike_gather_pallas
// (pallas_call at :65) over a split bucket's virtual rows, with the
// jax.ops.segment_sum over row_map and the ring.at[(t + d) % D].add that the
// reference runs around it, bucket by bucket
// (src/repro/snn/simulator.py:644-655).  A bucket that is not split goes in
// as identity rows (its first n_p rows), so a max_k step makes one launch.
// Bound on the H100: HBM bytes, and only the bytes that carry information:
// the col of every real slot (4 bytes), the weight of every real slot whose
// source is active (of every real slot on a row_dot bucket), row_len,
// row_ptr, the activity, and the ring rows read and written.  On the
// microcircuit at max_k=512 that is 1.14 GB of cols (fill 0.891) for
// 33-3,900 active sources a step; on the plastic Brunel net at max_k=64
// (row_dot) 0.13 GB.  The row_dot tiles are copied whole, padding included
// (0.19 GB there), so that a non-finite act[0] reaches every padded row as
// it does in spike_gather's row_dot variant.
// Design:
//   0. (bitmask modes, with an active bucket) one warp per 32 ids packs the
//      activity into a bitmask in device memory (bit set iff act != 0);
//      grid.sync(); each block copies it into shared memory.  Where the whole
//      activity vector fits shared memory beside the stages (the Brunel
//      net's 12,500 ids: 50 KB) it is staged there instead and no bitmask is
//      made;
//   1. work is cut by virtual rows, not real rows: an upload-time table
//      (kernels/segment_gather.py:segment_plan) cuts every bucket's virtual
//      rows into tiles of at most 256 slots (one row where a row is wider).
//      Each warp of a persistent grid walks tiles gw, gw + nw, ... through
//      its own ring of stages in shared memory, `stages` tiles ahead: a
//      row_dot tile's cols and weights come in as cp.async.bulk copies that
//      lane 0 issues, completing on the stage's mbarrier; an active tile's
//      cols (a one-row tile: the row's real prefix) as the lanes' 16-byte
//      cp.async copies completing on the same barrier
//      (cp.async.mbarrier.arrive).  The warp then runs today's arithmetic
//      from the stage: lane j takes slots j, j+32, ... with __fmaf_rn, every
//      slot of a row_dot row, or only the slots whose source is active,
//      whose weights and activities it loads eight slots at a time so that
//      those dependent loads overlap; then the xor tree of
//      common.cuh:row_dot (skipped where every lane holds +0).  Each virtual
//      row's sum goes to an L2-resident scratch (vsum), and the stage back
//      to the copies, for the tile `stages` ahead;
//   2. grid.sync(); each real row adds its virtual rows' sums in ascending
//      order from +0.0 (ref.segment_add_ref), or takes its one row of an
//      identity bucket as it is, and adds that into ring[(t + d) % D] with
//      one __fadd_rn: today's index_add_ of a single row.  t is read from
//      device memory, so one captured launch serves every step.  The
//      buckets' write slots differ (one bucket a delay, D >= the largest
//      delay), so every (bucket, row) pair is its own thread's add.
// Choices, fixed here after timing them on the H100 at 5% activity (the
// sweep is in PERF.md): a warp owns its stages, since a block-wide stage of
// one 512-slot microcircuit row would leave most warps idle, and no release
// crosses warps; tiles of 256 slots (kernels/segment_gather.py:TILE_SLOTS;
// at their best stage counts 128 slots were 28% slower on the Brunel net,
// 512 11%, and on the microcircuit's 512-slot rows all three the same); two
// stages where a tile is one stream, three where a row_dot tile's weights
// come beside its cols (on the microcircuit 3 and 4 stages were 3% and 8%
// slower than 2; on the Brunel net 2 and 4 were 2% and 16% slower than 3);
// active tiles by the lanes' cp.async (bulk copies of the same short,
// data-dependent prefixes were 2.5% slower on the microcircuit).  A first
// design that carried each tile's active weights and activities in shared
// memory into the next tile's turn left room for fewer warps and ran slower
// than this one, in which 32 warps each wait on one tile's loads.
// Bits: the fma chain and the tree are row_dot's and row_dot_active's (the
// argument that skipped slots change no bit is in common.cuh).  No atomics.
// Weights: f32 or bf16 panels (one type a launch), widened exactly.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxBuckets = 32;  // kernels/segment_gather.py:MAX_BUCKETS
constexpr int kMaxWarps = 32;
constexpr int kMinWarps = 4;
constexpr int kMaxStages = 3;
constexpr int kUnroll = 8;  // a lane's slots whose loads go out together
// a block's barriers and stage descriptors, before the staged vector
constexpr int kMetaBytes = kMaxWarps * kMaxStages * (8 + 16);

enum Mode { kActSmem = 0, kBitsSmem = 1, kGlobal = 2 };

struct SegArgs {
  const float* act;  // (n,) activity, from an earlier launch
  int n;
  uint32_t* bits;  // (words,) bitmask, written in phase 0 (bitmask modes)
  int words;
  float* ring;  // (D, n_p), updated in place
  int n_p;
  const int64_t* t;  // the step, in device memory
  int D;
  float* vsum;       // every bucket's virtual-row sums, at voff[b]
  const int* tiles;  // (n_tiles, 3): bucket, first virtual row, rows
  int n_tiles;
  int nd;
  int any_active;  // a bucket reduces with row_dot_active
  int stages;       // a warp's stages
  int stage_bytes;  // a stage: its cols, then (a row_dot bucket) its weights
  int cols_bytes;   // where a stage's weights start
  int region_bytes;  // staged activity or bitmask, a multiple of 16
  const int* cols[kMaxBuckets];
  const void* w[kMaxBuckets];
  const int* row_len[kMaxBuckets];  // (R,) real slots a row; null: K
  const int* row_ptr[kMaxBuckets];  // (n_p + 1,); null: identity rows
  int K[kMaxBuckets];
  int voff[kMaxBuckets];
  int wofs[kMaxBuckets];    // bucket b adds to ring slot (t + wofs[b]) % D
  int rowdot[kMaxBuckets];  // the bucket's reduction: row_dot (1) or active
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// The barrier's phase waits for this thread's earlier cp.async copies (its
// pending count is raised now and lowered when they complete).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// the 16-byte-aligned middle of [src, src + bytes)
struct Span {
  uintptr_t a0, a1;
};
__device__ __forceinline__ Span middle(const unsigned char* src, size_t bytes) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  return Span{(s + 15) & ~uintptr_t(15), (s + bytes) & ~uintptr_t(15)};
}

// Copy the ends of [src, src + bytes) outside its aligned middle (all of it
// when there is none) to dst with plain 2-byte loads; returns the middle's
// bytes, which copy_middle moves.  dst = src (mod 16).
__device__ __forceinline__ uint32_t copy_ends(unsigned char* dst, const unsigned char* src,
                                              size_t bytes) {
  if (bytes == 0) return 0;
  const Span m = middle(src, bytes);
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t e = s + bytes;
  const bool has_mid = m.a1 > m.a0;
  const uintptr_t head_end = has_mid ? m.a0 : e;
  for (uintptr_t p = s; p < head_end; p += 2) {
    *reinterpret_cast<unsigned short*>(dst + (p - s)) =
        __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  if (!has_mid) return 0;
  for (uintptr_t p = m.a1; p < e; p += 2) {
    *reinterpret_cast<unsigned short*>(dst + (p - s)) =
        __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  return static_cast<uint32_t>(m.a1 - m.a0);
}

__device__ __forceinline__ void copy_middle(unsigned char* dst, const unsigned char* src,
                                            size_t bytes, uint64_t* bar) {
  if (bytes == 0) return;
  const Span m = middle(src, bytes);
  if (m.a1 > m.a0) {
    bulk_copy(dst + (m.a0 - reinterpret_cast<uintptr_t>(src)),
              reinterpret_cast<const void*>(m.a0), static_cast<uint32_t>(m.a1 - m.a0), bar);
  }
}

// A tile: its bucket, first virtual row, rows, and the slots its first row
// takes (every slot on a row_dot bucket; else a one-row tile's row_len, and
// a tile of several rows every slot, the padding's (col 0, weight 0)
// changing no bit, as in common.cuh).  Lane 0 writes it beside the stage
// when it issues the tile; the warp reads it there.
struct Desc {
  int b, r0, nr, len0;
};

// One tile's place in its bucket and in a stage.
template <class W>
struct Tile {
  int b, r0, nr, K, len0;
  bool rowdot;
  const unsigned char* csrc;  // the tile's first col in device memory
  const unsigned char* wsrc;  // its first weight
  int* scols;                 // its cols in the stage (dst = src mod 16)
  const W* sw_dense;          // its weights in the stage (row_dot buckets)

  __device__ __forceinline__ Tile(const SegArgs& a, const Desc& d, unsigned char* st, int wstart)
      : b(d.b), r0(d.r0), nr(d.nr), K(a.K[d.b]), len0(d.len0) {
    rowdot = a.rowdot[b] != 0;
    const size_t first = static_cast<size_t>(r0) * K;
    csrc = reinterpret_cast<const unsigned char*>(a.cols[b] + first);
    wsrc = reinterpret_cast<const unsigned char*>(static_cast<const W*>(a.w[b]) + first);
    scols = reinterpret_cast<int*>(st + (reinterpret_cast<uintptr_t>(csrc) & 15));
    sw_dense = reinterpret_cast<const W*>(st + wstart + (reinterpret_cast<uintptr_t>(wsrc) & 15));
  }

  // slots of row i the reduction takes
  __device__ __forceinline__ int extent(int i) const { return i == 0 ? len0 : K; }
};

// The descriptor of the warp's tile at index `tile` of the table, loaded by
// each lane for one of the next 32 tiles (two dependent loads every 32
// tiles, off the per-tile path).
__device__ __forceinline__ Desc load_desc(const SegArgs& a, int tile) {
  Desc d;
  d.b = __ldg(a.tiles + 3 * tile);
  d.r0 = __ldg(a.tiles + 3 * tile + 1);
  d.nr = __ldg(a.tiles + 3 * tile + 2);
  const int K = a.K[d.b];
  d.len0 = K;
  if (!a.rowdot[d.b] && d.nr == 1 && a.row_len[d.b] != nullptr)
    d.len0 = min(__ldg(a.row_len[d.b] + d.r0), K);
  return d;
}

// Lane 0: start loading a row_dot bucket's tile into a stage, its cols and
// its weights: the ends that are not 16-byte aligned by plain stores before
// the arrive, the aligned middles by bulk copies counted on the stage's
// barrier.
// Returns whether it wrote any byte of the stage with a plain store.
template <class W>
__device__ bool issue_tile(const SegArgs& a, const Desc& d, unsigned char* st, int wstart,
                           uint64_t* bar, Desc* meta) {
  *meta = d;
  const Tile<W> x(a, d, st, wstart);
  const size_t cbytes = static_cast<size_t>(x.nr) * x.K * 4;
  const size_t wbytes = static_cast<size_t>(x.nr) * x.K * sizeof(W);
  unsigned char* cdst = reinterpret_cast<unsigned char*>(x.scols);
  unsigned char* wdst = const_cast<unsigned char*>(reinterpret_cast<const unsigned char*>(x.sw_dense));
  const uint32_t tx = copy_ends(cdst, x.csrc, cbytes) + copy_ends(wdst, x.wsrc, wbytes);
  mbar_arrive_expect_tx(bar, tx);
  copy_middle(cdst, x.csrc, cbytes, bar);
  copy_middle(wdst, x.wsrc, wbytes, bar);
  return tx != cbytes + wbytes;
}

// Every lane: start loading an active bucket's tile into a stage with
// cp.async (16 bytes a copy where the range is 16-byte aligned, else 4), its
// cols only (a one-row tile: the row's real prefix, rounded up to 16 bytes
// inside the row), completing on the stage's barrier; lane 0 writes the
// descriptor and arrives.
template <class W>
__device__ void issue_active(const Desc& d, const Tile<W>& x, uint64_t* bar, Desc* meta,
                             int lane) {
  size_t bytes = static_cast<size_t>(x.nr) * x.K * 4;
  const uintptr_t s = reinterpret_cast<uintptr_t>(x.csrc);
  if (x.nr == 1) {
    const uintptr_t end = (s + 4 * static_cast<size_t>(x.len0) + 15) & ~uintptr_t(15);
    if (end - s < bytes) bytes = end - s;
  }
  unsigned char* dst = reinterpret_cast<unsigned char*>(x.scols);
  if ((s & 15) == 0 && (bytes & 15) == 0) {
    for (size_t off = 16 * static_cast<size_t>(lane); off < bytes; off += 32 * 16)
      cp_async16(dst + off, x.csrc + off);
  } else {
    for (size_t off = 4 * static_cast<size_t>(lane); off < bytes; off += 32 * 4)
      cp_async4(dst + off, x.csrc + off);
  }
  cp_async_arrive(bar);
  __syncwarp();
  if (lane == 0) {
    *meta = d;
    mbar_arrive(bar);
  }
}

__device__ __forceinline__ float stage_weight(const float* w) { return *w; }
__device__ __forceinline__ float stage_weight(const __nv_bfloat16* w) {
  return __bfloat162float(*w);
}

// The xor tree of common.cuh:row_dot.  Where every lane's sum is +0 (the
// bits 0: no lane took an active slot, or its products cancelled exactly)
// the tree would add +0s and give +0: it is skipped.
__device__ __forceinline__ float tree_sum(float acc) {
  if (!__any_sync(0xffffffffu, __float_as_uint(acc) != 0u)) return acc;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  return acc;
}

// One tile from its stage: each row's reduction, today's arithmetic with
// the cols read from shared memory.  Lane j takes slots j, j+32, ... in
// ascending order with __fmaf_rn: on a row_dot bucket every slot (with the
// weights from the stage), else only the slots whose source is active,
// their weight and activity loaded kUnroll slots a lane at a time, so that
// those dependent loads are in flight together; then the xor tree.  The
// sum goes to vsum.
template <int kMode, class W, class Bits>
__device__ void gather_tile(const SegArgs& a, const Tile<W>& x, const float* s_act, Bits bits,
                            int lane) {
  if (x.rowdot && kMode == kActSmem) {  // nothing to load: row_dot from shared memory
    for (int i = 0; i < x.nr; ++i) {
      float acc = 0.0f;
      for (int k = lane; k < x.K; k += 32) {
        const int slot = i * x.K + k;
        acc = __fmaf_rn(stage_weight(x.sw_dense + slot), s_act[x.scols[slot]], acc);
      }
      acc = tree_sum(acc);
      if (lane == 0) a.vsum[a.voff[x.b] + x.r0 + i] = acc;
    }
    return;
  }
  const W* wg = reinterpret_cast<const W*>(x.wsrc);
  for (int i = 0; i < x.nr; ++i) {
    const int len = x.extent(i);
    float acc = 0.0f;
    for (int k0 = lane; k0 < len; k0 += 32 * kUnroll) {
      bool on[kUnroll];
      float wv[kUnroll], av[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + 32 * u;
        const int slot = i * x.K + k;
        const int c = k < len ? x.scols[slot] : 0;
        if (x.rowdot) {
          on[u] = k < len;
        } else if (kMode == kActSmem) {
          on[u] = k < len && s_act[c] != 0.0f;  // pack_active_bits' test
        } else {
          on[u] = k < len && bits.test(c);
        }
        wv[u] = 0.0f;
        av[u] = 0.0f;
        if (on[u]) {
          wv[u] = x.rowdot ? stage_weight(x.sw_dense + slot) : load_weight(wg + slot);
          av[u] = kMode == kActSmem ? s_act[c] : __ldg(a.act + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (on[u]) acc = __fmaf_rn(wv[u], av[u], acc);
      }
    }
    acc = tree_sum(acc);
    if (lane == 0) a.vsum[a.voff[x.b] + x.r0 + i] = acc;
  }
}

// Phase 2 for (bucket b, real row r): the ascending sum of its virtual rows
// from +0.0 (an identity row: its one sum as it is), added into its ring row.
__device__ __forceinline__ void add_row(const SegArgs& a, int64_t t, int b, int r) {
  const float* vs = a.vsum + a.voff[b];
  const int* rp = a.row_ptr[b];
  float* p = a.ring + static_cast<size_t>((t + a.wofs[b]) % a.D) * a.n_p + r;
  const float old = *p;
  float s;
  if (rp == nullptr) {
    s = __ldcg(vs + r);
  } else {
    // four loads in flight at a time, added in order
    s = 0.0f;
    const int end = __ldg(rp + r + 1);
    int v = __ldg(rp + r);
    for (; v + 4 <= end; v += 4) {
      const float x0 = __ldcg(vs + v), x1 = __ldcg(vs + v + 1), x2 = __ldcg(vs + v + 2),
                  x3 = __ldcg(vs + v + 3);
      s = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(s, x0), x1), x2), x3);
    }
    for (; v < end; ++v) s = __fadd_rn(s, __ldcg(vs + v));
  }
  *p = __fadd_rn(old, s);
}

template <int kMode, class W>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    segment_gather_kernel(const __grid_constant__ SegArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  Desc* metas = reinterpret_cast<Desc*>(smem + kMaxWarps * kMaxStages * 8);
  unsigned char* region = smem + kMetaBytes;
  unsigned char* stages = region + a.region_bytes;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int gw = blockIdx.x * warps + warp;
  const int nw = gridDim.x * warps;
  const int S = a.stages;
  const int wstart = a.cols_bytes;
  uint64_t* my_bars = bars + warp * S;
  Desc* my_meta = metas + warp * S;
  unsigned char* my_stages = stages + static_cast<size_t>(warp) * S * a.stage_bytes;
  const int count = gw < a.n_tiles ? (a.n_tiles - gw + nw - 1) / nw : 0;
  // the warp's tiles gw, gw + nw, ...: lane l holds the descriptor of the
  // (32 m + l)-th, loaded when the issue reaches tile 32 m
  Desc batch{0, 0, 0, 0};
  // the stages whose last tile was written by plain stores or cp.async, which
  // the copy engine may overwrite only after a proxy fence
  uint32_t plain = 0;
  // every lane: start loading the warp's tile j into stage j % S
  auto issue = [&](int j) {
    if ((j & 31) == 0 && j + lane < count) batch = load_desc(a, gw + (j + lane) * nw);
    const int src = j & 31;
    const Desc d{__shfl_sync(0xffffffffu, batch.b, src), __shfl_sync(0xffffffffu, batch.r0, src),
                 __shfl_sync(0xffffffffu, batch.nr, src),
                 __shfl_sync(0xffffffffu, batch.len0, src)};
    const int s = j % S;
    unsigned char* st = my_stages + s * a.stage_bytes;
    if (!a.rowdot[d.b]) {  // an active tile: its cols by the lanes' cp.async
      issue_active<W>(d, Tile<W>(a, d, st, wstart), my_bars + s, my_meta + s, lane);
      plain |= 1u << s;
      return;
    }
    if ((plain >> s) & 1u) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bool ends = false;
    if (lane == 0) ends = issue_tile<W>(a, d, st, wstart, my_bars + s, my_meta + s);
    plain = (plain & ~(1u << s)) | (static_cast<uint32_t>(__shfl_sync(0xffffffffu, ends, 0)) << s);
  };
  if (lane == 0) {
    for (int s = 0; s < S; ++s) mbar_init(my_bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  // the first tiles need nothing of this step: their copies run during the
  // pack and the staging
  for (int j = 0; j < S && j < count; ++j) issue(j);
  cg::grid_group grid = cg::this_grid();
  if (kMode != kActSmem && a.any_active) {
    for (int word = gw; word < a.words; word += nw) {  // warp-uniform
      pack_active_bits(a.act, a.n, a.bits, word, lane);
    }
    grid.sync();  // every bit is written before any block reads one
  }
  float* s_act = reinterpret_cast<float*>(region);
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(region);
  if (kMode == kActSmem) {
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(a.act) & 15) == 0) {
      const int n4 = a.n >> 2;
#pragma unroll 4
      for (int i = threadIdx.x; i < n4; i += blockDim.x) {
        reinterpret_cast<float4*>(s_act)[i] = __ldg(reinterpret_cast<const float4*>(a.act) + i);
      }
      done = 4 * n4;
    }
    for (int i = done + threadIdx.x; i < a.n; i += blockDim.x) s_act[i] = __ldg(a.act + i);
  } else if (kMode == kBitsSmem) {
    for (int i = threadIdx.x; i < a.words; i += blockDim.x) s_bits[i] = __ldcg(a.bits + i);
  }
  __syncthreads();
  const SharedBits smem_bits{s_bits};
  const L2Bits l2_bits{a.bits};

  // each tile from its stage, which then goes back to the copy engine for
  // the tile `stages` ahead
  for (int j = 0; j < count; ++j) {
    const int s = j % S;
    mbar_wait(my_bars + s, (j / S) & 1);
    const Tile<W> x(a, my_meta[s], my_stages + s * a.stage_bytes, wstart);
    if (kMode == kBitsSmem) {
      gather_tile<kMode>(a, x, s_act, smem_bits, lane);
    } else {
      gather_tile<kMode>(a, x, s_act, l2_bits, lane);
    }
    __syncwarp();  // every lane's reads of the stage are done
    if (j + S < count) issue(j + S);
  }

  grid.sync();  // every virtual row's sum is in vsum
  const int64_t t = *a.t;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const long long total = static_cast<long long>(a.nd) * a.n_p;
  for (long long idx = tid; idx < total; idx += nthreads) {
    const int b = static_cast<int>(idx / a.n_p);
    add_row(a, t, b, static_cast<int>(idx - static_cast<long long>(b) * a.n_p));
  }
}

template <int kMode>
const void* kernel_for(int w_bf16) {
  return w_bf16 ? reinterpret_cast<const void*>(segment_gather_kernel<kMode, __nv_bfloat16>)
                : reinterpret_cast<const void*>(segment_gather_kernel<kMode, float>);
}

__host__ __device__ constexpr int round16(long long x) { return static_cast<int>((x + 15) & ~15LL); }

}  // namespace

extern "C" int repro_segment_gather_max_buckets() { return kMaxBuckets; }

// tiles: (n_tiles, 3) int32 over every bucket's virtual rows, the largest
// tile_slots slots.  vsum: scratch of sum(rows) floats, bucket b's at voff[b].
// bits: scratch of ceil(n / 32) words.  row_len, row_ptr: per bucket, may be
// null.  rowdot: per bucket 1 for row_dot.  wofs: per bucket (d % D), all
// different.  The activity is staged in shared memory where it fits beside
// kMinWarps warps' stages, else its bitmask (with an active bucket), else
// both are read from device memory.  A warp's stages: 2, or 3 with a row_dot
// bucket where that leaves kMinWarps warps.  config (5 ints, may be null):
// the mode (0 activity in shared memory, 1 bitmask there, 2 device memory),
// warps a block, stages, blocks, bytes of shared memory a block.
extern "C" int repro_segment_gather(const float* act, int n, uint32_t* bits, float* ring, int n_p,
                                    const int64_t* t, int D, float* vsum, const int* tiles,
                                    int n_tiles, int tile_slots, int nd, const void* const* cols,
                                    const void* const* w, int w_bf16, const void* const* row_len,
                                    const void* const* row_ptr, const int* K, const int* voff,
                                    const int* wofs, const int* rowdot, int* config, void* stream,
                                    int device) {
  if (nd < 1 || nd > kMaxBuckets || tile_slots < 1) return cudaErrorInvalidValue;
  for (int b = 0; b < nd; ++b) {
    for (int c = 0; c < b; ++c) {
      if (wofs[b] == wofs[c]) return cudaErrorInvalidValue;  // a shared write slot
    }
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  SegArgs a;
  a.act = act;
  a.n = n;
  a.bits = bits;
  a.words = (n + 31) / 32;
  a.ring = ring;
  a.n_p = n_p;
  a.t = t;
  a.D = D;
  a.vsum = vsum;
  a.tiles = tiles;
  a.n_tiles = n_tiles;
  a.nd = nd;
  a.any_active = 0;
  for (int b = 0; b < kMaxBuckets; ++b) {
    const bool used = b < nd;
    a.cols[b] = used ? static_cast<const int*>(cols[b]) : nullptr;
    a.w[b] = used ? w[b] : nullptr;
    a.row_len[b] = used ? static_cast<const int*>(row_len[b]) : nullptr;
    a.row_ptr[b] = used ? static_cast<const int*>(row_ptr[b]) : nullptr;
    a.K[b] = used ? K[b] : 0;
    a.voff[b] = used ? voff[b] : 0;
    a.wofs[b] = used ? wofs[b] : 0;
    a.rowdot[b] = used ? rowdot[b] : 1;
    if (used && !rowdot[b]) a.any_active = 1;
  }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  // a stage: the tile's cols (each at its address mod 16), then on a row_dot
  // bucket its weights
  bool any_rowdot = false;
  for (int b = 0; b < nd; ++b) any_rowdot = any_rowdot || rowdot[b];
  a.cols_bytes = round16(4LL * tile_slots + 16);
  a.stage_bytes = a.cols_bytes * (any_rowdot ? 2 : 1);
  const long long least = 2LL * kMinWarps * a.stage_bytes;
  const int act_bytes = round16(4LL * n);
  const int bit_bytes = round16(4LL * a.words);
  auto fits = [&](int bytes) { return kMetaBytes + bytes + least <= optin; };
  const int mode = fits(act_bytes) ? kActSmem : (a.any_active && fits(bit_bytes)) ? kBitsSmem
                                                                                    : kGlobal;
  a.region_bytes = mode == kActSmem ? act_bytes : mode == kBitsSmem ? bit_bytes : 0;
  const long long avail = static_cast<long long>(optin) - kMetaBytes - a.region_bytes;
  // two stages where a tile is one stream (cols), three where a row_dot
  // tile's weights come beside them
  int S = any_rowdot ? 3 : 2;
  long long warps = avail / (static_cast<long long>(S) * a.stage_bytes);
  if (warps < kMinWarps) {
    S = 2;
    warps = avail / (2LL * a.stage_bytes);
  }
  if (warps > kMaxWarps) warps = kMaxWarps;
  if (warps < 1) return cudaErrorInvalidValue;  // a tile larger than shared memory
  a.stages = S;
  const int threads = static_cast<int>(warps) * 32;
  const size_t smem =
      kMetaBytes + a.region_bytes + static_cast<size_t>(warps) * S * a.stage_bytes;
  const void* kernel = mode == kActSmem    ? kernel_for<kActSmem>(w_bf16)
                       : mode == kBitsSmem ? kernel_for<kBitsSmem>(w_bf16)
                                           : kernel_for<kGlobal>(w_bf16);
  int grid = 0;
  err = resident_blocks(kernel, device, threads, smem, &grid);
  if (err != cudaSuccess) return err;
  // no more blocks than the largest phase has work for
  const long long tile_blocks = (n_tiles + warps - 1) / warps;
  const long long row_blocks = (static_cast<long long>(nd) * n_p + threads - 1) / threads;
  const long long pack_blocks = (32LL * a.words + threads - 1) / threads;
  long long work = tile_blocks > row_blocks ? tile_blocks : row_blocks;
  if (pack_blocks > work) work = pack_blocks;
  if (work < grid) grid = static_cast<int>(work > 0 ? work : 1);
  if (config != nullptr) {
    config[0] = mode;
    config[1] = threads / 32;
    config[2] = S;
    config[3] = grid;
    config[4] = static_cast<int>(smem);
  }
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(threads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
