// The step front: everything of a partition's step before the exchange, in
// one launch.  The step t is read from device memory, and so are the rows it
// selects: the delivered slot is row t % D of the (D, n) ring (a single (n,)
// row passed as such is a ring of one row) and the history row is row t % D of
// the (D, n) hist; so one captured launch serves every step.  One thread per
// row r < n:
//   x = slot[r]                          the delivered ring row, read in place
//   x = x + sigma * normal(seed, t, ids[r])       (kDraw: the port's noise)
//   x = x + vtx[r, LIF_BIAS]                                          (kBias)
//   lif_advance(vtx[r, LIF_V], vtx[r, LIF_REF], x) -> v', refrac', s
//   vtx[r, LIF_V] = v', vtx[r, LIF_REF] = refrac', spikes[r] = s   (in place)
//   hist_row[r] = (uint8) s                          (kHist: hist[t % D])
//   tp'[r], tm'[r] = trace_decay(tp[r], s), trace_decay(tm[r], s) (kTraces)
//
// Replaces: src/repro/kernels/lif_step.py:lif_step_pallas (pallas_call at
// :38) without traces, and src/repro/kernels/fused_step.py:
// fused_pre_exchange_pallas (pallas_call at :450, body _make_pre_kernel:418)
// with them, together with the jnp around them in the reference's step
// (src/repro/snn/simulator.py:409-438, i_syn + noise + bias left to right,
// and :675-676, hist[t % D] = s).  Every value depends only on its own row,
// so one pass does it all, with the same operations in the same order: the
// noise routines of noise.cuh (noise_add_kernel's arithmetic), one __fadd_rn
// for each add, lif_advance and trace_decay of common.cuh.  So the front is
// bit for bit the chain it replaces (noise_add, the two contiguous() copies
// of vtx_state's columns, lif_step or pre_exchange, the two column writes,
// and post's uint8 history write) and its plain version
// (kernels/ref.py:step_front_ref).
//
// Bound on the H100: HBM bytes, and a launch.  A row reads the slot (4 B),
// its id (8 B, with the noise), v, refrac and bias (12 B of its vtx_state
// row) and writes v', refrac' (8 B), the spike (4 B) and the history byte:
// 37 bytes (53 with both traces read and written), and one Threefry cipher.
// At the microcircuit's 77,172 rows that is under a microsecond of HBM time,
// so the launch itself dominates, as it did for lif_step and pre_exchange;
// the design's gain is the launches it removes around them.  Design: 256
// threads a block, one row a thread.  vtx_state is a contiguous (n, ld)
// matrix (ld = 4 on the repo's nets, the widest model's state): a warp's
// three column loads fall in the same 32 x 16 contiguous bytes, so L1 serves
// the second and the third, and no shared-memory transpose is needed.  The
// step key is derived once a block (noise.cuh:step_key).
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "noise.cuh"

namespace {

constexpr int kThreads = 256;

// vtx_state's LIF columns (snn/neurons.py: LIF_V, LIF_REF, LIF_BIAS)
constexpr int kV = 0;
constexpr int kRef = 1;
constexpr int kBiasCol = 2;

struct FrontArgs {
  float* vtx;  // (n, ld), v and refrac written in place
  int ld;
  const float* slot;    // (slot_rows, n): row t % slot_rows is delivered
  int slot_rows;        // D for the ring, 1 for a single row (or slot + seam noise)
  const int64_t* ids;   // (n,) permanent ids (kDraw)
  float* spikes;        // (n,) out
  uint8_t* hist_row;    // (hist_rows, n): row t % hist_rows is written (kHist)
  int hist_rows;
  const float* tr_plus;   // (n,) (kTraces)
  const float* tr_minus;  // (n,) (kTraces)
  float* tp_out;          // (n,) out (kTraces)
  float* tm_out;          // (n,) out (kTraces)
  int n;
  LifParams p;
  uint32_t seed;
  const int64_t* t;  // the step, in device memory
  float sigma;
  float decay_plus;
  float decay_minus;
  ThreefryMul mul;
};

template <bool kTraces, bool kDraw, bool kBias, bool kHist>
__global__ void __launch_bounds__(kThreads) step_front_kernel(const FrontArgs a) {
  uint32_t s0 = 0, s1 = 0, s2 = 0;
  if constexpr (kDraw) {  // every thread of the block reaches the barrier
    step_key(a.seed, a.t, a.mul, s0, s1);
    s2 = threefry_parity(s0, s1);
  }
  // the offsets of the rows t selects, one 64-bit modulo each a block (by
  // thread 0; every thread reaches the barrier)
  __shared__ int64_t offset[2];
  if (threadIdx.x == 0) {
    const int64_t t = *a.t;
    offset[0] = (t % a.slot_rows) * a.n;
    offset[1] = (t % a.hist_rows) * a.n;
  }
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n) return;
  // every load before the first store: the in-place row and the outputs
  // share no __restrict__ promise with the inputs
  float* row = a.vtx + static_cast<int64_t>(r) * a.ld;
  float x = a.slot[offset[0] + r];
  const float v0 = row[kV];
  const float r0 = row[kRef];
  const float bias = kBias ? row[kBiasCol] : 0.0f;
  const float tp = kTraces ? a.tr_plus[r] : 0.0f;
  const float tm = kTraces ? a.tr_minus[r] : 0.0f;
  if constexpr (kDraw) {
    const uint64_t id = static_cast<uint64_t>(a.ids[r]);
    x = __fadd_rn(x, scaled_normal(s0, s1, s2, static_cast<uint32_t>(id >> 32),
                                   static_cast<uint32_t>(id), a.sigma, a.mul));
  }
  if constexpr (kBias) x = __fadd_rn(x, bias);
  float v, refrac, s;
  lif_advance(v0, r0, x, a.p, v, refrac, s);
  row[kV] = v;
  row[kRef] = refrac;
  a.spikes[r] = s;
  if constexpr (kHist) a.hist_row[offset[1] + r] = static_cast<uint8_t>(s);
  if constexpr (kTraces) {
    a.tp_out[r] = trace_decay(tp, s, a.decay_plus);
    a.tm_out[r] = trace_decay(tm, s, a.decay_minus);
  }
}

// Picks the instantiation of the four flags (traces, draw, bias, hist), one
// flag at a time, and launches it.
template <bool... kSet>
cudaError_t launch(const FrontArgs& a, const bool (&flags)[4], cudaStream_t stream) {
  if constexpr (sizeof...(kSet) == 4) {
    step_front_kernel<kSet...><<<(a.n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a);
    return cudaGetLastError();
  } else {
    return flags[sizeof...(kSet)] ? launch<kSet..., true>(a, flags, stream)
                                  : launch<kSet..., false>(a, flags, stream);
  }
}

}  // namespace

// vtx: (n, ld) contiguous; slot: (slot_rows, n); spikes: (n,); ids: (n,) or
// null without the draw; hist_row: (hist_rows, n) or null; the four traces all
// set or all null; t: the step, one int64 in device memory.
extern "C" int repro_step_front(float* vtx, int ld, const float* slot, int slot_rows,
                                const int64_t* ids, float* spikes, uint8_t* hist_row,
                                int hist_rows, const float* tr_plus, const float* tr_minus,
                                float* tp_out, float* tm_out, int n, float v_rest,
                                float v_reset, float v_thresh, float decay,
                                float one_minus_decay, float r_m, float ref_steps,
                                uint32_t seed, const int64_t* t, float sigma, float decay_plus,
                                float decay_minus, int draw, int bias, void* stream,
                                int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  if (slot_rows < 1 || hist_rows < 1) return cudaErrorInvalidValue;
  const FrontArgs a{vtx, ld, slot, slot_rows, ids, spikes, hist_row, hist_rows, tr_plus,
                    tr_minus, tp_out, tm_out, n,
                    make_lif_params(v_rest, v_reset, v_thresh, decay, one_minus_decay, r_m,
                                    ref_steps),
                    seed, t, sigma, decay_plus, decay_minus, threefry_mul()};
  const bool flags[4] = {tr_plus != nullptr, draw != 0, bias != 0, hist_row != nullptr};
  return launch<>(a, flags, static_cast<cudaStream_t>(stream));
}
