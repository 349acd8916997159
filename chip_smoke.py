#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) through its main path on
one card and check it.

    python3 chip_smoke.py [--seed 0] [--scale 1.0]

It drives two networks, each at k=1 and at k=4, and then two built from
procedural rules (``--scale`` sizes both microcircuits).  The microcircuit
is built once, as the uniform k=4 net ``to_dcsr(net,
assignment=block_partition(net.n, 4), uniform=True)`` (3 inert padding
neurons); the k=1 paths run its ``merge_to_single``, which has the same
labelling, so the k=4 rasters are compared with the k=1 ones entry by
entry.  The main path is the k=1 non-plastic LIF network at the full
width of the Potjans-Diesmann microcircuit (scale 1.0: 77,169 neurons,
about 0.3 B synapses, delay buckets d=8 and d=15, noise sigma 1.0):
``Session(SimConfig())`` (which builds the delay-bucketed ELL panels) ->
``run`` with ``RateMonitor`` and ``RasterMonitor``.  With the default
``gather="auto"`` the first chunk runs the ``fused`` engine and, while
the spike rate stays under the event threshold, later chunks run
``fused_event`` (the step front, ``step_front``: the noise, the bias, LIF
in place in ``vtx_state`` and the history row in one launch, plus the
event gather).  Phases, each printing its own lines:

  1. device: the card's name, count, name and power limit from nvidia-smi;
  2. build: every CUDA kernel from ``src/repro_torch/kernels/csrc``,
     with nvcc's register, shared-memory and spill report;
  3. kernels vs plain at the main path's shapes (the session's own panels,
     inputs from ``--seed``): ``lif_step`` bit-exact, ``spike_gather``
     (with the panels' row lengths) within rtol=atol=1e-5, equal to itself
     over whole rows and with the bitmask in device memory, and, through
     the reference's ring formulation, bit-equal to ``post_exchange``'s
     forced ``row_dot`` variant; ``fused_step`` (row lengths, the session's
     recorded ``reduce``) bit-exact against its forced ``row_dot`` variant,
     its L2 bitmask and ``lif_step`` then ``spike_gather``, and within 1e-5
     of its plain version;
  4. main path: 1000 steps; the launch counts, set to 0 just before the run
     and read just after, must match the gather mode of every chunk (a
     ``fused`` step launches ``noise_add`` and ``fused_step``, a
     ``fused_event`` step ``step_front`` and the event kernel);
  5. the event kernel against its plain version, its forced ``row_dot``
     variant and the dense kernels, on spike vectors of the main path's
     raster;
  6. the unfused path: 256 steps on the ``unfused`` engine, counts set to
     0 before and read after, whose raster must equal the main path's
     first 256 steps; then a small network on the card against the plain
     torch versions on the CPU, fed the seam's numpy noise and then the
     port's own noise, whose vectors must be bit-identical on both; then
     NaN weights on silent sources of a small net (k=1 and k=4): the
     panels holding them record ``row_dot`` and ``spike_gather``, the
     event kernel, ``fused_step`` and the three ``post_exchange`` passes
     give NaN in exactly their plain versions' rows;
  7. timing with CUDA events at the main path's shapes: each kernel, its
     plain version, ``torch.sparse.mm`` over the same synapses for the
     gathers, and the bound (the bytes and operations this run's inputs
     need); the two gathers at a 5% vector and at a spike vector of the
     main path, with the bitmask read from device memory too;
     ``fused_step`` on the main path's next step beside its ``row_dot``
     variant; ``noise_add`` bit-exact against its plain version over 2^20
     shuffled ids (past 2^32, repeated) at four steps (t up to 2^31 + 3),
     with and without a strided bias, both erfinv branches taken, the full
     vector (``ops.step_noise``) likewise, and on the main path's own ids,
     ring slots and bias column; then 100 steps of each engine from the
     main path's end state with the port's own noise and through the old
     noise chain (the seam fed the full vector: full draw,
     ``index_select``, add, bias add), bit-identical, and ``noise_add``'s
     time beside that chain's ops;
  [front] the step front's kernel bit-identical to its plain version and
     to the chain it replaced (``noise_add``, the two column copies,
     ``lif_step``, the two column writes, the uint8 history write) on the
     main path's own ids, ring slot, ``vtx_state`` and history row, with
     and without the draw and the bias; its time, bound and the chain's
     device time; 100 ``fused_event`` steps from the main path's end
     state through the front and through the old chain
     (``make_core_step(front=False)``), bit-identical in raster,
     ``vtx_state``, ring and hist; then the dense and the event engine's
     us/step from one state of the main path.

The k>1 microcircuit path: ``Session(d4, SimConfig(), engine="spmd",
devices=[card] * 4)``, four partitions on the one card, stepped in lockstep
(index exchange, overlap ``local``, ``fused_split`` and then
``fused_split_event``):
  k1. the split kernels at that path's shapes on partition 0:
      ``post_exchange`` (full, local and remote pass, with row lengths
      and the recorded ``reduce``; the local pass also at a 5% vector,
      since the main-path vector may leave partition 0's own slice silent)
      bit-exact against its forced ``row_dot`` variant, and with the event kernel's split use (with
      and without the clear) against ``spike_gather`` composed with the
      reference's ring formulation, within rtol=atol=1e-5 of the plain
      version;
  k2. 1000 steps with both monitors, counts set to 0 before and read after
      and matched to the chunks' gather modes; overflow 0; the raster equal
      to the k=1 main path's;
  k3. 200 steps each of ``overlap="off"``, ``"double_buffer"`` and
      ``fused=False`` (the k>1 ``unfused`` engine), each with its counts
      and a raster equal to k2's;
  k4. timing of the split kernels (each ``post_exchange`` pass, the local
      one at both vectors of k1, beside its ``row_dot`` variant, its plain version, its real-work bound and
      ``torch.sparse.mm`` over its panel on the same vector; the event
      kernel's remote pass at two vectors, as in 7) and the split
      engines' us/step; the host time of the step front a step, the noise
      alone (``noise_add`` per partition against the chain it replaced)
      and the whole front (``step_front`` against its old chain);
  [front] 100 steps of ``fused_split`` and ``fused_split_event`` from the
      k>1 path's end state through the front and through the old chain,
      bit-identical; then, after every timed microcircuit run, the device
      kernels of one step of each k=1 and k>1 engine from
      ``torch.profiler``: through the front (or the own noise on
      ``fused``), the old chain and the old noise chain.

The plastic path is ``balanced_ei(n=12500, stdp=True)`` (Brunel's model A
counts: 10,000 E and 2,500 I neurons, epsilon 0.1, 15.6 M synapses of which
10 M plastic E->E, 15 delay buckets), built as the uniform k=4 net and
merged -> ``Session(SimConfig())``, which takes the ``fused_plastic``
engine:
  8. the plastic kernels against their plain versions on that session's
     panels: ``stdp_update`` bit-exact for every bucket, ``fused_step_plastic``
     bit-exact against ``lif_step`` + trace decay + ``spike_gather`` +
     ``stdp_update`` and against its plain version but for the currents
     (rtol=atol=1e-5);
  9. 1000 steps with both monitors, every chunk on ``fused_plastic``, counts
     set to 0 just before and read just after; plastic slots changed,
     non-plastic and padding slots bit-identical to the initial weights,
     plastic weights within ``[w_min, w_max]``;
 10. 256 steps of ``SimConfig(fused=False)`` (``lif_step``, then per bucket
     ``spike_gather`` and ``stdp_update``), counts checked, whose raster,
     traces and weights equal a fresh ``fused_plastic`` run's bit for bit;
 11. both plastic engines' us/step; a small plastic net on the card against
     the CPU plain versions; timing of both plastic kernels, their plain
     versions and their bounds.

The k>1 plastic path: the k=4 net on the one card with ``SimConfig()``
(dense exchange of spikes and pre-traces, overlap ``local``,
``fused_split_plastic``: the step front with both trace decays, the local
``post_exchange`` pass, the remote ``post_exchange_plastic`` pass):
 12. ``pre_exchange`` and both variants of ``post_exchange_plastic`` on
     partition 0 against their plain versions and the unfused kernels;
 13. 1000 steps, counts checked; raster, hist, traces and weights
     bit-identical to the k=1 plastic path's;
 14. 256 steps each of ``overlap="off"``, ``"double_buffer"``,
     ``exchange="index"`` and ``fused=False``, each bit-identical in hist,
     traces and weights to a fresh k=1 ``fused_plastic`` run; timing;
 [front] the step front with traces on partition 0's state against its
     plain version and the old chain (``noise_add``, ``pre_exchange``);
     100 ``fused_split_plastic`` steps through the front and the old
     chain, bit-identical in raster, state, traces and weights; the
     front's time with traces; the device kernels of one step of each.

Procedural construction, ``RuleSpec`` -> ``build_network`` (the keystream
kernel on the card, the float assembly in numpy on the host) -> ``Session``:
 p1. the keystream kernel bit-exact against its plain version on the card
     and against numpy ``crng.word_matrix``: 8,192 x 11,136 words (a bound
     on the build's calls), the build's largest call (8,192 x 8,348), odd
     j0 with odd n_words, gathered ids with repeats up to 2^31-1, the work
     items' edges (one and two words a row from an odd j0, 7 words from an
     odd j0, counters up to 2^32-1 at the last words below 2^32), and a
     zero-row and a zero-word call, which launch nothing;
 p2. ``balanced_ei_rules(n=12500, stdp=True)`` built as 4 uniform blocks on
     the card and by the numpy oracle: every partition array, dist, meta
     and rule_spec equal; then ``Session(spec)`` (k=1, ``fused_plastic``)
     and ``Session(spec, k=4, engine="spmd")`` on the card, 256 steps each,
     raster, hist, traces and weights bit-identical;
 p3. the slice's main path, ``Session(microcircuit_rules(scale))`` with
     ``SimConfig()``: the build's host seconds split into the keystream
     (launches and copies), the numpy assembly and the ELL and upload, the
     keystream's launches (set to 0 before the build, equal to its calls);
     1000 steps with both monitors, counts per chunk gather mode; rows of
     three partitions of a k=64 block partition, built by the numpy oracle,
     equal to the card-built net's;
 p4. the keystream kernel's time with CUDA events at 8,192 x 11,136 words,
     its plain version's, and its bound: the larger of the bytes over the
     HBM rate and the cipher's 67 integer operations over both integer
     pipes; beside it, as a diagnostic, the built kernel's item loop (G
     ciphers) counted by pipe from its SASS (``cuobjdump``).

Snapshots (``Session.save`` / ``Session.restore`` / ``Session(path)`` /
``run(checkpoint_every=...)`` in the on-disk format 1.0 of
``docs/FORMAT.md``), each after every timed run of the session it saves,
written with fsync on under ``_snap/`` beside this script (the free space
checked first; removed at the end):
 s1. after the k=1 microcircuit's profiler phase: ``save`` at its current
     t, ``Session.restore(path)`` onto the card, then 200 steps of the live
     and of the restored session: rasters, spike counts, ``vtx_state``,
     ``ring``, ``hist`` and traces bit-equal;
 s2. after the k=4 Brunel path's profiler phase: ``save``,
     ``Session.restore`` at k=4 (``[card] * 4``), k=2 (``[card] * 2``) and
     k=1, 256 steps each against the live session's own 256: rasters, the
     synced weights, traces and hist bit-equal by permanent id (``ring``
     and ``vtx_state`` too at k=4; at k=2 and 1 their largest differences,
     the rounding of the split engines' local-then-remote sums, are
     printed); then ``run(512, checkpoint_every=128, max_to_keep=2)`` on
     the live session against the k=4 restore's run without checkpoints,
     two step directories left, and ``Session(root)`` resuming from the
     newest with every carry array bit-equal; then ``docs/FORMAT.md``'s
     NumPy-only reader in a subprocess on the snapshot the card wrote.
  ``[snap]`` lines give the bytes on disk, the save stall (``state_to_dcsr``
  and the host copies) and the write to ``wait()`` in seconds and GB/s,
  ``load_latest_valid`` and the restored Session's build in seconds, the
  checkpoint stalls, the host's peak RSS and nvidia-smi's name and power
  limit.

It ends with a JSON line of kernel figures, the nvidia-smi line, and
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a card it exits 1 before printing any result.
"""
from __future__ import annotations

import argparse
import functools
import gc
import json
import math
import os
import re
import resource
import shutil
import subprocess
import sys
import time
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import event_step as event_mod  # noqa: E402
from repro_torch.kernels import fused_step as fused_mod  # noqa: E402
from repro_torch.kernels import lif_step as lif_mod  # noqa: E402
from repro_torch.kernels import noise as noise_mod  # noqa: E402
from repro_torch.kernels import spike_gather as gather_mod  # noqa: E402
from repro_torch.kernels import split_step as split_mod  # noqa: E402
from repro_torch.kernels import step_front as front_mod  # noqa: E402
from repro_torch.kernels import stdp_update as stdp_mod  # noqa: E402
from repro_torch.kernels import keystream as ks_mod  # noqa: E402
from repro_torch.builder import (  # noqa: E402
    balanced_ei_rules, build_network, build_partition, crng, microcircuit_rules,
)
from repro_torch.core import block_partition, merge_to_single  # noqa: E402
from repro_torch.io import fsync_enabled, load_binary, snapshot_steps  # noqa: E402
from repro_torch.snn import (  # noqa: E402
    RasterMonitor, RateMonitor, Session, SimConfig, balanced_ei, microcircuit, to_dcsr,
)
from repro_torch.snn.neurons import LIF_BIAS, LIF_PARAM_KEYS, LIF_REF, LIF_V  # noqa: E402
from repro_torch.kernels.dispatch import launch_row_dot, panel_reduce  # noqa: E402
from repro_torch.snn.simulator import FRONT_ENGINES, slot_tables, state_reduce  # noqa: E402

STEPS = 1000
PARITY_STEPS = 256
VARIANT_STEPS = 200
ENGINE_STEPS = 100
K_PARTS = 4  # partitions of the k>1 paths, all on the one card
PLASTIC_N = 12500  # Brunel (2000) model A: 10,000 E and 2,500 I neurons
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS_PER_S = 67e12  # H100 SXM, non-tensor f32, published
# H100 SXM integer pipes: 132 SMs x 64 lanes x 1.98 GHz boost clock (the
# clock behind the published 67 TFLOP/s f32: 132 x 128 lanes x 2 x 1.98 GHz)
# for the ALU pipe (integer add, logic, shift) and for the FMA pipe's integer
# side (IMAD); an SM dispatches 128 lanes' instructions a clock in all.
INT32_ALU_OPS_PER_S = 132 * 64 * 1.98e9
INT32_FMA_OPS_PER_S = 132 * 64 * 1.98e9
DISPATCH_PER_S = 132 * 128 * 1.98e9
# Threefry-2x32-20 is 20 rotates, 20 xors and 27 adds a cipher: its bound
# (cipher_ms) is these 67 integer operations over both integer pipes at
# once, the least any split between the pipes could take.
CIPHER_INT_OPS = 20 + 20 + 27
# How the built keystream kernel issues them, read from its SASS
# (keystream_sass, a diagnostic of the kernel, not its bound): a rotate is a
# funnel shift (SHF.L.W, ALU pipe) or, in csrc/threefry.cuh's multiply form,
# an IMAD.WIDE.U32 (FMA pipe) whose OR folds into the xor's LOP3 (ALU pipe);
# an add is IADD3 (ALU pipe), IMAD.IADD or VIADD (FMA pipe).  An IMAD.WIDE
# is counted as two dispatch slots of its pipe (it writes a register pair),
# and VIADD, sm_90's add of an immediate or uniform operand, on the FMA pipe
# (undocumented; ptxas uses it for the adds it moves off the ALU pipe).
SASS_ADDS = {"IADD3": "alu", "IMAD.IADD": "fma", "VIADD": "fma"}
# LOP3 truth tables of a two-input xor and of the folded (a | b) ^ c, in any
# operand order
LUT_XOR = {"0x3c", "0x5a", "0x66"}
LUT_OR_XOR = {"0x1e", "0x36", "0x56"}
# SASS opcodes by the sm_90 pipe that executes them (Nsight Compute's pipe
# names); any other counts as "other"
SASS_PIPES = {"IADD3": "alu", "LOP3": "alu", "SHF": "alu", "PRMT": "alu", "ISETP": "alu",
              "LEA": "alu", "SEL": "alu", "IMAD": "fma", "VIADD": "fma", "LDG": "lsu",
              "STG": "lsu", "BRA": "control", "BSSY": "control", "BSYNC": "control"}
# keystream shapes of microcircuit_rules(scale=1.0): a bound on its calls, a
# full chunk of 8,192 rows x 4 Irwin-Hall words for each of the largest
# rule's 2,784 candidate sources (L23E->L23I, whose 5,834 target rows never
# fill a chunk); and its largest real call, the weight words of rule 0
# (L23E->L23E, 2,087 candidates) for the chunk of rows 8,192-16,383
KS_ROWS, KS_WORDS = 8192, 11136
KS_REAL_R0, KS_REAL_WORDS = 8192, 8348
ROW_CHECK_K, ROW_CHECK_PARTS = 64, (0, 31, 63)
BUILD_ARRAYS = ("global_ids", "row_ptr", "col_idx", "vtx_model", "edge_model", "vtx_state",
                "edge_state", "coords")
COUNTERS = (lif_mod.COUNTER, gather_mod.COUNTER, fused_mod.COUNTER, event_mod.COUNTER,
            stdp_mod.COUNTER, fused_mod.PLASTIC_COUNTER, split_mod.PRE_COUNTER,
            split_mod.POST_COUNTER, split_mod.PLASTIC_COUNTER, ks_mod.COUNTER, noise_mod.COUNTER,
            front_mod.COUNTER)
SOURCES = {
    "lif_step": ("src/repro_torch/kernels/csrc/lif_step.cu",
                 "src/repro/kernels/lif_step.py:38"),
    "spike_gather": ("src/repro_torch/kernels/csrc/spike_gather.cu",
                     "src/repro/kernels/spike_gather.py:65"),
    "fused_step": ("src/repro_torch/kernels/csrc/fused_step.cu",
                   "src/repro/kernels/fused_step.py:140"),
    "event_post_exchange": ("src/repro_torch/kernels/csrc/event_step.cu",
                            "src/repro/kernels/event_step.py:198"),
    "stdp_update": ("src/repro_torch/kernels/csrc/stdp_update.cu",
                    "src/repro/kernels/stdp_update.py:70"),
    "fused_plastic_step": ("src/repro_torch/kernels/csrc/fused_plastic_step.cu",
                           "src/repro/kernels/fused_step.py:327"),
    "pre_exchange": ("src/repro_torch/kernels/csrc/pre_exchange.cu",
                     "src/repro/kernels/fused_step.py:450"),
    "post_exchange": ("src/repro_torch/kernels/csrc/post_exchange.cu",
                      "src/repro/kernels/fused_step.py:545"),
    "post_exchange_remote_plastic": ("src/repro_torch/kernels/csrc/post_exchange_plastic.cu",
                                     "src/repro/kernels/fused_step.py:751"),
    "post_exchange_plastic": ("src/repro_torch/kernels/csrc/post_exchange_plastic.cu",
                              "src/repro/kernels/fused_step.py:901"),
    "event_post_exchange_split": ("src/repro_torch/kernels/csrc/event_step.cu",
                                  "src/repro/kernels/event_step.py:198"),
    "keystream": ("src/repro_torch/kernels/csrc/keystream.cu",
                  "src/repro/kernels/keystream.py:58"),
    # not a TPU kernel: the reference draws its noise as jnp outside Pallas,
    # takes a partition's ids of it and adds it to the delivered slot
    "noise_add": ("src/repro_torch/kernels/csrc/noise.cu",
                  "src/repro/snn/simulator.py:411-438"),
    # the step front replaces lif_step_pallas (no traces) and the trace
    # variant of fused_pre_exchange_pallas, with the noise, bias and history
    # jnp around them
    "step_front": ("src/repro_torch/kernels/csrc/step_front.cu",
                   "src/repro/kernels/lif_step.py:38"),
    "step_front_traces": ("src/repro_torch/kernels/csrc/step_front.cu",
                          "src/repro/kernels/fused_step.py:450"),
}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls.

    The card first spins (``torch.cuda._sleep``) for longer than the host
    takes to enqueue the calls, so the timed calls run back to back on the
    device and the CUDA events see device time, not the host's launch
    overhead (ctypes, allocation) between calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * host_s + 1e-3) * 2e9))  # at most 2 GHz SM clock
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = F32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def phase_device():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    say("device", f"{name}; {count} card(s); nvidia-smi: {smi}")
    say("device", f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return name, count, smi


def phase_build():
    info = _build.build()
    say("build", f"{info.path.name}: {info.seconds:.1f} s"
        + (" (found built)" if info.cached else ""))
    for line in info.log.splitlines():
        if line.startswith("==") or any(
            w in line for w in ("registers", "spill", "smem", "stack frame")
        ):
            say("build", line.strip())
    _build.library()


def lif_params(net):
    p = dict(net.registry.spec("lif").params)
    return {"dt": float(net.meta["dt"]), **{k: p[k] for k in LIF_PARAM_KEYS}}


def phase_kernels(sim, params, rng):
    """Each kernel against its plain version on the session's panels."""
    dev = sim.device
    n_p = sim.dev.n_p
    vtx = sim.dev.vtx_state0
    v = vtx[:, LIF_V].contiguous()
    refrac = torch.from_numpy(rng.integers(0, 3, n_p).astype(np.float32)).to(dev)
    i_tot = vtx[:, LIF_BIAS] + torch.from_numpy(
        rng.normal(0.0, 1.0, n_p).astype(np.float32)
    ).to(dev)
    cols, weights = sim.dev.cols, sim.dev.weights0
    errs = {}

    got = lif_mod.lif_step_cuda(v, refrac, i_tot, params=params)
    want = ref.lif_step_ref(v, refrac, i_tot, **params)
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            "lif_step kernel differs from its plain version")
    errs["lif_step"] = float((got[0] - want[0]).abs().max())
    say("kernels", f"lif_step n={n_p}: bit-exact vs plain ({int(got[2].sum())} spikes)")

    act = (torch.rand(n_p, generator=torch.Generator(dev).manual_seed(1), device=dev)
           < 0.05).float()
    row_len = sim.dev.row_len
    errs["spike_gather"] = 0.0
    curs = []
    for c, w, rl, d, rb in zip(cols, weights, row_len, sim.dev.delays, sim.dev.reduce):
        got = gather_mod.spike_gather_cuda(act, c, w, rl, reduce=(rb,))
        want = ref.spike_gather_ref(act, c, w)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        require(torch.equal(got, gather_mod.spike_gather_cuda(act, c, w, reduce=(rb,))),
                "spike_gather with row_len differs from spike_gather over whole rows")
        require(torch.equal(got, gather_mod.spike_gather_cuda(act, c, w, rl, reduce=(rb,),
                                                              shared_bitmask=False)),
                "spike_gather differs with the bitmask read from device memory")
        curs.append(got[:n_p])
        err = float((got - want).abs().max())
        errs["spike_gather"] = max(errs["spike_gather"], err)
        say("kernels", f"spike_gather d={d} panel {tuple(c.shape)}, row_len: equal to "
            f"whole rows and to the bitmask in device memory; max |kernel - plain| = "
            f"{err:.3e} (rtol=atol=1e-5)")
    # against the row_dot kernels: post_exchange's forced row_dot variant,
    # through the reference's ring formulation, on the session's panels
    ring, slot, _ = event_case(sim)
    clear_tab, onehot_tab = slot_tables(sim.d_ring, sim.dev.delays, dev)
    clear, onehot = clear_tab[slot], onehot_tab[slot]
    row_dot = split_mod.post_exchange_cuda(act, ring, clear, onehot, cols, weights,
                                           reduce="row_dot")
    exact = ref._ring_accumulate(ring, clear, onehot, curs)
    require(torch.equal(row_dot.view(torch.int32), exact.view(torch.int32)),
            "spike_gather with row_len differs from the row_dot kernel (post_exchange)")
    say("kernels", "spike_gather with row_len: ring bit-equal (signed zeros too) to the "
        "row_dot variant of post_exchange (5% active)")

    # fused_step with the panels' row lengths and the recorded reduction
    require(sim.dev.reduce == ("active",) * len(cols), f"reduce {sim.dev.reduce}")
    v2, r2, s2, curs = fused_mod.fused_step_cuda(v, refrac, i_tot, cols, weights, row_len,
                                                 params=params, reduce=sim.dev.reduce)
    v1, r1, s1 = lif_mod.lif_step_cuda(v, refrac, i_tot, params=params)
    require(torch.equal(v2, v1) and torch.equal(r2, r1) and torch.equal(s2, s1),
            "fused_step LIF phase differs from the lif_step kernel")
    forced = fused_mod.fused_step_cuda(v, refrac, i_tot, cols, weights, params=params,
                                       reduce="row_dot")
    in_l2 = fused_mod.fused_step_cuda(v, refrac, i_tot, cols, weights, row_len, params=params,
                                      reduce=sim.dev.reduce, shared_bitmask=False)
    for cur, cf, cl, c, w, rl, rb in zip(curs, forced[3], in_l2[3], cols, weights, row_len,
                                         sim.dev.reduce):
        require(torch.equal(cur.view(torch.int32), cf.view(torch.int32)),
                "fused_step differs from its forced row_dot variant")
        require(torch.equal(cur.view(torch.int32), cl.view(torch.int32)),
                "fused_step differs with the bitmask read from L2")
        require(torch.equal(cur, gather_mod.spike_gather_cuda(s1, c, w, rl, reduce=(rb,))),
                "fused_step gather phase differs from the spike_gather kernel")
    _, _, s_p, curs_p = ref.fused_step_ref(v, refrac, i_tot, cols, weights, params=params)
    require(torch.equal(s2, s_p), "fused_step spikes differ from the plain version")
    errs["fused_step"] = 0.0
    for a, b in zip(curs, curs_p):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        errs["fused_step"] = max(errs["fused_step"], float((a - b).abs().max()))
    say("kernels", f"fused_step (row_len, reduce {sim.dev.reduce}, {int(s2.sum())} spikes): "
        "bit-exact vs its forced row_dot variant, vs the bitmask read from L2 and vs lif_step + "
        f"spike_gather kernels; max |kernel - plain| = {errs['fused_step']:.3e} "
        "(rtol=atol=1e-5)")
    return (v, refrac, i_tot, act), errs


def run_session(ses, steps):
    rate, raster = RateMonitor(), RasterMonitor()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ses.run(steps, monitors=[rate, raster])
    torch.cuda.synchronize()
    return res, rate, raster, time.perf_counter() - t0


def reset_counts():
    for c in COUNTERS:
        c.launches = 0


def read_counts():
    return {c.name: c.launches for c in COUNTERS}


def only(**launches):
    """The counts of a run that launched these kernels and no other."""
    return {c.name: launches.get(c.name, 0) for c in COUNTERS}


def phase_main_path(ses, n, pops, tag="main", need_event=True):
    """1000 steps with both monitors; the launch counts, set to 0 just before
    the run and read just after, must match every chunk's gather mode.
    ``pops`` maps each population to its range of permanent ids."""
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    res, rate, raster, secs = run_session(ses, STEPS)
    launches = read_counts()
    modes = ses.last_gather_modes
    dense = sum(c for c, m in zip(res.chunks, modes) if m == "dense")
    event = sum(c for c, m in zip(res.chunks, modes) if m == "event")
    say(tag, f"chunks {res.chunks}, gather modes {modes}")
    require(dense + event == STEPS, f"gather modes {modes}")
    require(event > 0 or not need_event, "the main path never took the event gather")
    require(launches == only(step_front=event, fused_step=dense, event_post_exchange=event,
                             noise_add=dense),
            f"launches {launches} for {dense} dense and {event} event steps")
    counts = res.spike_count
    require(counts.shape == (STEPS,) and np.isfinite(rate.rates).all(), "bad spike counts")
    require(int(counts.sum()) > 0, "the network never spiked")
    require(raster.raster.shape == (STEPS, n), f"raster {raster.raster.shape}")
    require(int(raster.raster.sum()) == int(counts.sum()), "raster and counts disagree")
    peak = torch.cuda.max_memory_allocated()
    say(tag, f"{STEPS} steps ({STEPS * ses.dt:.0f} ms model time), {dense} on 'fused' and "
        f"{event} on 'fused_event': {secs:.3f} s, {secs / STEPS * 1e6:.1f} us/step "
        "(host clock, monitors included)")
    say(tag, f"launches {launches}; spikes: {int(counts.sum())} "
        f"({counts.mean() / n:.6f} per neuron a step); mean rate {rate.rates.mean():.2f} Hz; "
        f"peak device memory {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
    rates = _population_rates(raster.raster, ses, pops)
    say(tag, "population rates (Hz): " + ", ".join(f"{k} {v:.2f}" for k, v in rates.items()))
    require(all(np.isfinite(v) for v in rates.values()) and any(rates.values()),
            f"population rates {rates}")
    return raster.raster, launches


def pd14_populations(scale):
    """Permanent-id ranges of ``microcircuit(scale)``'s populations."""
    from repro_torch.snn.network import PD14_POPS, PD14_SIZES

    sizes = np.maximum((np.asarray(PD14_SIZES) * scale).astype(np.int64), 2)
    edges = np.concatenate([[0], np.cumsum(sizes)])
    return dict(zip(PD14_POPS, zip(edges[:-1], edges[1:])))


def _population_rates(raster, ses, pops):
    per = raster[:, np.argsort(ses.permanent_ids)].sum(axis=0)
    secs = raster.shape[0] * ses.dt * 1e-3
    return {p: float(per[a:b].sum()) / ((b - a) * secs) for p, (a, b) in pops.items()}


def event_case(sim, t=STEPS):
    """A ring and the slots of an event step at ``t``."""
    D = sim.d_ring
    ring = torch.from_numpy(
        np.random.default_rng(t).normal(0.0, 1.0, (D, sim.dev.n_p)).astype(np.float32)
    ).to(sim.device)
    return ring, t % D, [(t + d) % D for d in sim.dev.delays]


def next_step_inputs(ses):
    """``(v, refrac, i_tot)`` of a k=1 session's next step from its state:
    the delivered ring slot plus the port's noise plus the bias, as
    ``make_core_step`` forms them."""
    sim, st = ses.simulator, ses.state
    t, vtx = st["t"], st["vtx_state"]
    noise = ops.step_noise(sim.cfg.seed, t, sim.net.n, sim.noise_sigma, device=sim.device)
    ids = torch.from_numpy(ses.permanent_ids).to(sim.device)
    i_tot = (st["ring"][t % sim.d_ring] + noise.index_select(0, ids)) + vtx[:, LIF_BIAS]
    return vtx[:, LIF_V].contiguous(), vtx[:, LIF_REF].contiguous(), i_tot


def phase_event(sim, raster):
    """The event kernel against its plain version and the dense kernels, on
    spike vectors of the main path (and one whose ids overflow the buffer)."""
    plan, cols, weights = sim.event_plan, sim.dev.cols, sim.dev.weights0
    row_len = sim.dev.row_len
    n_p = sim.dev.n_p
    clear_tab, onehot_tab = slot_tables(sim.d_ring, sim.dev.delays, sim.device)
    busiest = int(raster.sum(axis=1)[128:].argmax()) + 128
    acts = {f"main-path step {j}": raster[j] for j in (STEPS // 2, busiest)}
    acts["10% active (overflow)"] = (
        np.random.default_rng(5).random(n_p) < 0.1).astype(np.uint8)
    err, flagged = 0.0, []
    for what, a in acts.items():
        act = torch.from_numpy(a.astype(np.float32)).to(sim.device)
        ring, slot, write = event_case(sim)
        got, want, dense = ring.clone(), ring.clone(), ring.clone()
        flags = event_mod.event_post_exchange_cuda(act, got, slot, write, plan, cols, weights,
                                                   row_len, reduce=sim.dev.reduce)
        want_flags = event_mod.event_post_exchange_plain(act, want, slot, write, plan,
                                                         cols, weights)
        require(torch.equal(flags, want_flags), f"event flags differ from plain ({what})")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        dense[slot] = 0.0
        for c, w, rl, ws, rb in zip(cols, weights, row_len, write, sim.dev.reduce):
            dense[ws] += gather_mod.spike_gather_cuda(act, c, w, rl, reduce=(rb,))[:n_p]
        require(torch.equal(got, dense), f"event ring differs from the dense kernels' ({what})")
        row_dot = split_mod.post_exchange_cuda(act, ring, clear_tab[slot], onehot_tab[slot],
                                               cols, weights, reduce="row_dot")
        require(torch.equal(got, row_dot), f"event ring differs from the row_dot kernel's "
                f"(post_exchange) ({what})")
        forced = ring.clone()
        event_mod.event_post_exchange_cuda(act, forced, slot, write, plan, cols, weights,
                                           reduce="row_dot")
        require(torch.equal(got, forced), f"event ring differs from its forced row_dot "
                f"variant ({what})")
        err = max(err, float((got - want).abs().max()))
        frac = float(flags.float().mean())
        flagged.append(frac)
        say("event", f"{what}: {int(a.sum())} spikes, {frac:.4f} of {flags.numel()} "
            f"(bucket, block) pairs flagged (blocks of {plan.block_r} rows); flags equal "
            "plain, ring bit-equal to spike_gather's, to its row_dot variant's and to "
            "post_exchange's row_dot variant, "
            "max |kernel - plain| = "
            f"{float((got - want).abs().max()):.3e} (rtol=atol=1e-5)")
    return err, acts[f"main-path step {STEPS // 2}"]


def phase_parity(net, main_raster, nd):
    ses = Session(net, SimConfig(fused=False))
    require(ses.engine_choice.engine == "unfused", f"engine {ses.engine_choice}")
    reset_counts()
    _, _, raster, secs = run_session(ses, PARITY_STEPS)
    launches = read_counts()
    require(launches == only(lif_step=PARITY_STEPS, spike_gather=PARITY_STEPS * nd,
                             noise_add=PARITY_STEPS),
            f"unfused path launches {launches}")
    require(np.array_equal(raster.raster, main_raster[:PARITY_STEPS]),
            "unfused raster differs from the main path's")
    say("parity", f"unfused {PARITY_STEPS} steps: raster identical to the main path's "
        f"(fused, then fused_event); {secs / PARITY_STEPS * 1e6:.1f} us/step; launches {launches}")
    return launches


def phase_small_net():
    """A small net on the card against the plain torch versions on the CPU:
    first both fed the same numpy noise through the simulator's noise seam,
    then each drawing the port's own noise, whose vectors must be
    bit-identical on the two devices.  The gather sums in another order on
    the card, so a membrane can sit an ulp apart; up to 1% of the spikes
    may differ."""
    small = to_dcsr(microcircuit(scale=0.02, seed=1), k=1)
    noise = np.random.default_rng(3).normal(0.0, 1.0, (PARITY_STEPS, small.n)).astype(np.float32)
    for label, noise_fn in (("the seam's numpy noise", lambda t: noise[t]),
                            ("the port's own noise", None)):
        rasters = []
        for device in ("cuda", "cpu"):
            s = Session(small, SimConfig(fused=True), device=device, _noise_fn=noise_fn)
            mon = RasterMonitor()
            s.run(PARITY_STEPS, monitors=[mon])
            rasters.append(mon.raster)
        spikes = int(rasters[0].sum())
        differ = np.flatnonzero((rasters[0] != rasters[1]).any(axis=1))
        n_diff = int((rasters[0] != rasters[1]).sum())
        say("parity", f"microcircuit(0.02), {PARITY_STEPS} steps, {label}, card vs CPU plain "
            f"versions: {spikes} vs {int(rasters[1].sum())} spikes, {n_diff} raster entries "
            "differ" + (f" (first at step {differ[0]})" if len(differ) else ""))
        require(spikes > 0, "small net never spiked")
        require(n_diff <= 0.01 * spikes, f"card and CPU rasters disagree on the small net "
                f"({label})")
    cfg, sigma = SimConfig(), float(small.meta["noise_sigma"])
    for t in range(PARITY_STEPS):
        a, b = (ops.step_noise(cfg.seed, t, small.n, sigma, device=device)
                for device in ("cuda", "cpu"))
        require(torch.equal(a.cpu().view(torch.int32), b.view(torch.int32)),
                f"the port's noise of step {t} differs between the card and the CPU")
    say("parity", f"the port's own noise: the {PARITY_STEPS} steps' ({small.n},) vectors the "
        "small net draws are bit-identical on the card and on the CPU (no seam)")


def _csr(bucket, n, dev):
    """The bucket's real synapses as a CSR matrix.  Multapses repeat a
    column within a row, which the invariant check refuses but the product
    sums correctly (the result is compared with the kernel's)."""
    counts = bucket.valid.sum(axis=1)
    crow = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    with warnings.catch_warnings():  # torch's notes on beta CSR support
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(crow),
            torch.from_numpy(bucket.cols[bucket.valid].astype(np.int64)),
            torch.from_numpy(bucket.weights[bucket.valid]),
            size=(bucket.cols.shape[0], n), check_invariants=False,
        ).to(dev)


def gather_traffic(act, cols, row_len, rows=None):
    """``(real, active, moved)`` of a row_len gather over one panel: its real
    slots, those whose source is active in ``act``, and the bytes it moves
    in 32-byte sectors (each row's cols, and one sector of weights for each
    aligned group of 8 slots holding an active one).  ``rows``, a bool
    ``(R,)`` mask, keeps only the rows read (the event kernel's flagged
    rows).  Counted on the card from this run's inputs."""
    R, K = cols.shape
    require(K % 8 == 0, f"panel width {K} is not a whole number of sectors")
    lens = row_len.long() if rows is None else row_len.long() * rows
    live = torch.arange(K, device=cols.device)[None, :] < lens[:, None]
    on = live & (act.index_select(0, cols.view(-1)).view(R, K) != 0)
    moved = 32 * (int(((lens + 7) // 8).sum()) + int(on.view(R, K // 8, 8).any(-1).sum()))
    return int(lens.sum()), int(on.sum()), moved


def event_traffic(act, plan, flags, cols, row_len, n_p):
    """``gather_traffic`` over the rows < ``n_p`` of the flagged blocks of
    every bucket, and the number of those (bucket, row) pairs."""
    real = active = moved = n_rows = 0
    for f, c, rl in zip(flags, cols, row_len):
        rows = f.bool().repeat_interleave(plan.block_r)[: c.shape[0]]
        rows[n_p:] = False
        r_, a_, m_ = gather_traffic(act, c, rl, rows)
        real, active, moved, n_rows = real + r_, active + a_, moved + m_, n_rows + int(rows.sum())
    return real, active, moved, n_rows


def phase_timing(ses, params, inputs, event_act, errs, launches):
    sim = ses.simulator
    v, refrac, i_tot, act = inputs
    n_p = sim.dev.n_p
    cols, weights = sim.dev.cols, sim.dev.weights0
    nd = len(cols)
    out = []

    lif_bytes = 6 * 4 * n_p
    t_k = cuda_ms(lambda: lif_mod.lif_step_cuda(v, refrac, i_tot, params=params), 200)
    t_p = cuda_ms(lambda: ref.lif_step_ref(v, refrac, i_tot, **params), 50)
    b, by = bound_ms(lif_bytes, 10 * n_p)
    say("timing", f"lif_step n={n_p}: kernel {t_k * 1e3:.2f} us, plain {t_p * 1e3:.2f} us, "
        f"bound {b * 1e3:.3f} us ({lif_bytes} B)")
    out.append(dict(name="lif_step", ms=t_k, plain_ms=t_p, bound_ms=b, bound_by=by,
                    library_ms=None))

    # spike_gather at two activity vectors: the 5% vector of phase 3 and a
    # spike vector of the main path; the bytes it must move depend on both.
    # Every timed launch takes the reduction the session recorded: the
    # wrappers' default "auto" would check the weights (a reduction over the
    # panel and a device sync) inside the timed loop
    row_len, red = sim.dev.row_len, sim.dev.reduce
    R = cols[0].shape[0]
    panel_bytes = sum(c.numel() * 8 for c in cols)
    real_syn = sum(int(b.valid.sum()) for b in sim.ell.buckets)
    csrs = [_csr(bucket, n_p, v.device) for bucket in sim.ell.buckets]
    eact = torch.from_numpy(event_act.astype(np.float32)).to(v.device)
    gathers = {}
    for label, a in (("5% active", act), ("main-path step", eact)):
        a2 = a[:, None].contiguous()
        t = dict(ms=0.0, ms_no_row_len=0.0, ms_bitmask_l2=0.0, library_ms=0.0)
        real = active = moved = 0
        for b, (c, w, rl, csr) in enumerate(zip(cols, weights, row_len, csrs)):
            rb = red[b:b + 1]
            torch.testing.assert_close(torch.sparse.mm(csr, a2)[:, 0],
                                       gather_mod.spike_gather_cuda(a, c, w, rl, reduce=rb),
                                       rtol=1e-5, atol=1e-5)
            t["ms"] += cuda_ms(lambda c=c, w=w, rl=rl, rb=rb: gather_mod.spike_gather_cuda(
                a, c, w, rl, reduce=rb), 20)
            t["ms_no_row_len"] += cuda_ms(
                lambda c=c, w=w, rb=rb: gather_mod.spike_gather_cuda(a, c, w, reduce=rb), 20)
            t["ms_bitmask_l2"] += cuda_ms(
                lambda c=c, w=w, rl=rl, rb=rb: gather_mod.spike_gather_cuda(
                    a, c, w, rl, reduce=rb, shared_bitmask=False), 20)
            t["library_ms"] += cuda_ms(lambda csr=csr: torch.sparse.mm(csr, a2), 20)
            r_, a_, m_ = gather_traffic(a, c, rl)
            real, active, moved = real + r_, active + a_, moved + m_
        # each launch reads the activity and row_len and writes R currents
        nb = 4 * (real + active) + nd * (4 * n_p + 8 * R)
        t["bound_ms"], t["bound_by"] = bound_ms(nb, 2 * active)
        t.update(real=real, active=active, moved=moved, bytes=nb)
        gathers[label] = t
        say("timing", f"spike_gather, both buckets, {label} ({int(a.sum())} of {n_p} ids): "
            f"kernel {t['ms']:.4f} ms; whole rows (no row_len) {t['ms_no_row_len']:.4f} ms; "
            f"bitmask in device memory {t['ms_bitmask_l2']:.4f} ms; torch.sparse.mm "
            f"{t['library_ms']:.4f} ms; moves about {moved / 1e9:.4f} GB ({real} real slots' "
            f"cols and one sector per 8 slots holding an active one, in 32-byte sectors: "
            f"{moved / t['ms'] / 1e6:.0f} GB/s); bound {t['bound_ms']:.4f} ms ({t['bound_by']}: "
            f"{nb / 1e9:.4f} GB = 4 B x {real} real slots' cols + 4 B x {active} active "
            "slots' weights + activity, row_len and currents)")
    # fused_step on the main path's next step (its end state, the ring slot
    # it delivers, the port's noise and the bias): the gathers read the
    # step's own spikes, so its bound counts what those spikes need
    fv, fr, fi = next_step_inputs(ses)
    fs = lif_mod.lif_step_cuda(fv, fr, fi, params=params)[2]
    f_real = f_active = f_moved = 0
    for c, rl in zip(cols, row_len):
        r_, a_, m_ = gather_traffic(fs, c, rl)
        f_real, f_active, f_moved = f_real + r_, f_active + a_, f_moved + m_
    # the state read (v, refrac, i_tot) and written (v, refrac, spikes), the
    # bitmask, and per bucket row_len read and R currents written
    f_state = lif_bytes + 4 * (n_p // 32 + 1) + nd * 8 * R
    f_bytes = 4 * (f_real + f_active) + f_state
    b, by = bound_ms(f_bytes, 10 * n_p + 2 * f_active)
    b_pad, _ = bound_ms(lif_bytes + panel_bytes + nd * R * 4,
                        10 * n_p + sum(2 * c.numel() for c in cols))
    tk = cuda_ms(lambda: fused_mod.fused_step_cuda(fv, fr, fi, cols, weights, row_len,
                                                   params=params, reduce=sim.dev.reduce), 20)
    tk_dot = cuda_ms(lambda: fused_mod.fused_step_cuda(fv, fr, fi, cols, weights, params=params,
                                                       reduce="row_dot"), 20)
    tp = cuda_ms(lambda: ref.fused_step_ref(fv, fr, fi, cols, weights, params=params), 5)
    fs2 = fs[:, None].contiguous()
    f_lib = sum(cuda_ms(lambda csr=csr: torch.sparse.mm(csr, fs2), 20) for csr in csrs)
    say("timing", f"fused_step ({nd} buckets), the main path's step {ses.t} ({int(fs.sum())} "
        f"spikes): kernel {tk:.4f} ms (moves about {(f_moved + f_state) / 1e9:.4f} GB: "
        f"{(f_moved + f_state) / tk / 1e6:.0f} GB/s); its row_dot variant {tk_dot:.4f} ms; "
        f"plain {tp:.3f} ms; torch.sparse.mm over both buckets on the same spikes {f_lib:.4f} "
        f"ms; bound {b:.4f} ms ({by}: {f_bytes / 1e9:.4f} GB = 4 B x {f_real} real slots' cols "
        f"+ 4 B x {f_active} active slots' weights + state, bitmask, row_len and currents); "
        f"padded bound {b_pad:.4f} ms (every slot's col and weight)")
    out.append(dict(name="fused_step", ms=tk, plain_ms=tp, bound_ms=b, bound_by=by,
                    library_ms=f_lib, ms_row_dot=tk_dot, bound_ms_padded=b_pad,
                    vector=f"the main path's step {ses.t}: {int(fs.sum())} spikes"))
    del csrs
    g_p = sum(cuda_ms(lambda c=c, w=w: ref.spike_gather_ref(act, c, w), 5)
              for c, w in zip(cols, weights))
    g5, gm = gathers["5% active"], gathers["main-path step"]
    g_pad, _ = bound_ms(panel_bytes + nd * (4 * n_p + 4 * R), 2 * sum(c.numel() for c in cols))
    g_real, _ = bound_ms(8 * real_syn + nd * (4 * n_p + 4 * R), 2 * real_syn)
    say("timing", f"spike_gather plain version (5% active) {g_p:.3f} ms; earlier bounds: "
        f"{g_pad:.4f} ms padded ELL ({panel_bytes / 1e9:.3f} GB), {g_real:.4f} ms every real "
        "synapse's col and weight")
    out.append(dict(name="spike_gather", ms=g5["ms"], plain_ms=g_p, bound_ms=g5["bound_ms"],
                    bound_by=g5["bound_by"], library_ms=g5["library_ms"],
                    bound_ms_real_synapses=g_real, bound_ms_padded_ell=g_pad,
                    ms_no_row_len=g5["ms_no_row_len"], ms_bitmask_l2=g5["ms_bitmask_l2"],
                    ms_main_path=gm["ms"], library_ms_main_path=gm["library_ms"],
                    bound_ms_main_path=gm["bound_ms"],
                    ms_main_path_bitmask_l2=gm["ms_bitmask_l2"],
                    vector="5% active; *_main_path: a spike vector of the main path"))

    # the event kernel on the same two vectors: what it must move depends on
    # the blocks the vector flags and on its active ids
    plan = sim.event_plan
    events = {}
    for label, a in (("main-path step", eact), ("5% active", act)):
        ring, slot, write = event_case(sim)
        flags = event_mod.event_post_exchange_cuda(a, ring, slot, write, plan, cols, weights,
                                                   row_len, reduce=red)
        real, active, moved, rows = event_traffic(a, plan, flags, cols, row_len, n_p)
        n_ids = int(a.sum())
        e_bytes = (4 * (real + active) + n_p * 4 * 2 + rows * 12
                   + n_ids * (8 + nd * plan.num_blocks) + flags.numel() * 4)
        t = dict(
            ms=cuda_ms(lambda: event_mod.event_post_exchange_cuda(
                a, ring, slot, write, plan, cols, weights, row_len, reduce=red), 20),
            ms_bitmask_l2=cuda_ms(lambda: event_mod.event_post_exchange_cuda(
                a, ring, slot, write, plan, cols, weights, row_len, reduce=red,
                shared_bitmask=False), 20),
        )
        t["bound_ms"], t["bound_by"] = bound_ms(e_bytes, 2 * active)
        events[label] = t
        say("timing", f"event_post_exchange, {label} ({n_ids} spikes, {rows} of {nd * n_p} "
            f"(bucket, row) pairs in flagged blocks): kernel {t['ms']:.4f} ms, bitmask in L2 "
            f"{t['ms_bitmask_l2']:.4f} ms; torch.sparse.mm over both buckets "
            f"{gathers[label]['library_ms']:.4f} ms; moves about {moved / 1e9:.4f} GB of panel "
            f"({moved / t['ms'] / 1e6:.0f} GB/s); bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}: {e_bytes / 1e9:.4f} GB = 4 B x {real} real slots' cols + 4 B x "
            f"{active} active slots' weights + activity, ring, row_len, ids and touch bytes)")
    em, e5 = events["main-path step"], events["5% active"]
    ring, slot, write = event_case(sim)
    tp = cuda_ms(lambda: event_mod.event_post_exchange_plain(eact, ring, slot, write, plan,
                                                             cols, weights), 5)
    say("timing", f"event_post_exchange plain version (main-path step) {tp:.3f} ms")
    out.append(dict(name="event_post_exchange", ms=em["ms"], plain_ms=tp, bound_ms=em["bound_ms"],
                    bound_by=em["bound_by"], library_ms=gm["library_ms"],
                    ms_bitmask_l2=em["ms_bitmask_l2"], ms_5pct=e5["ms"],
                    bound_ms_5pct=e5["bound_ms"], library_ms_5pct=g5["library_ms"],
                    vector="a spike vector of the main path; *_5pct: 5% active"))

    for k in out:
        src, rep = SOURCES[k["name"]]
        k.update(route="cuda", source=src, replaces=rep, launches=launches[k["name"]],
                 max_abs_err=errs[k["name"]],
                 path="unfused" if k["name"] in ("spike_gather", "lif_step") else "main")
    return out


def phase_engines(ses):
    """Host-clock us/step of the dense and the event engine from the state
    the main path ended in, alternating dense, event, dense, event."""
    sim = ses.simulator
    mode0, per = sim.gather, {}
    for mode in ("dense", "event", "dense", "event"):
        sim.set_gather(mode)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(ses.state, ENGINE_STEPS)
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) / ENGINE_STEPS * 1e6
        per.setdefault(sim.engine_choice.engine, []).append(f"{us:.1f}")
    sim.set_gather(mode0)
    say("timing", f"engines from the main path's state, {ENGINE_STEPS} steps each, no "
        "monitors (host clock): "
        + "; ".join(f"{e} {', '.join(us)} us/step" for e, us in per.items()))


# -- the per-step noise and non-finite weights ----------------------------------

# f32 operations of one id's noise in csrc/noise.cu: the uniform (4), the
# square and log1p's add, sub, compare, div and mul (6), Cephes' log (28),
# the branch select and w's shift (4), the Horner polynomial (17), sqrt(2)
# and sigma (2)
NOISE_F32_OPS = 61


def noise_bound(n, bytes_per_id, f32_per_id):
    """(ms, what bounds it, times) of a noise launch over ``n`` ids: the
    function needs one cipher an id (its bits) and one a launch (the step
    key, which the kernel derives once a block: not counted again), each
    its 67 integer operations (``cipher_ms``), and ``f32_per_id`` float
    operations an id, against ``bytes_per_id`` moved an id."""
    times = dict(bytes=n * bytes_per_id / HBM_BYTES_PER_S * 1e3,
                 f32=n * f32_per_id / F32_FLOPS_PER_S * 1e3, int32=cipher_ms(n + 1))
    return (*bound_of(times), times)


def noise_add_case(n, card, seed):
    """``step_noise_add``'s inputs at ``n`` ids: a ring slot, the ids (a
    permutation, every fifth moved past 2^32, every eleventh a repeat of the
    first) and a vtx_state-like matrix whose column 3 is the strided bias."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(n).astype(np.int64)
    ids[::5] += 2**32 + 17
    ids[1::11] = ids[0]
    x = rng.normal(0.0, 1.0, n).astype(np.float32)
    vtx = rng.normal(0.0, 1.0, (n, 4)).astype(np.float32)
    return (torch.from_numpy(x).to(card), torch.from_numpy(ids).to(card),
            torch.from_numpy(vtx).to(card))


def count_device_kernels(fn, warm):
    """The device kernels ``fn()`` launches, by name, from ``torch.profiler``
    (CUPTI); empty when the trace dropped them all.  ``warm()``, the same work on
    other operands, runs first in the profiler's warm-up step, whose events
    are dropped: without it, a trace of one k>1 Brunel step missed launches
    (2 of its 4 step fronts)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    events = []
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # one cycle: nothing to accumulate
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: events.extend(p.events())) as prof:
            warm()
            torch.cuda.synchronize()
            prof.step()
            fn()
            torch.cuda.synchronize()
            prof.step()
    return Counter(e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA)


def old_chain_step(sim, gather):
    """The simulator's step of ``gather`` with the noise through the seam,
    fed the port's own full vector (the noise kernel over the ids
    ``0..n-1``, one launch a step), without the step front: the chain the
    engines ran before ``step_noise_add`` (full draw, ``index_select``, add,
    bias add, the column copies, ``lif_step``), on the same panels."""
    from repro_torch.snn.simulator import make_core_step

    neg0 = torch.full((sim.net.n,), -0.0, device=sim.device)
    all_ids = torch.arange(sim.net.n, device=sim.device)
    choice = sim._choice(gather)
    return make_core_step(
        registry=sim.net.registry, models_present=sim._models, dt=sim.dt,
        noise_sigma=sim.noise_sigma, seed=sim.cfg.seed, d_ring=sim.d_ring, dev=sim.dev,
        noise_ids=sim._noise_ids, engine_choice=choice,
        stdp_params=sim.stdp_params, event_plan=sim.event_plan if choice.event else None,
        noise_fn=lambda t: noise_mod.noise_add_cuda(neg0, all_ids, sim.cfg.seed, t,
                                                    sim.noise_sigma),
        front=False,
    )


def step_kernels(sim, step, state):
    """The device kernels of one step of the step function ``step`` (k=1)
    or of the partitions' step functions (a list, k>1) from ``state`` (on a
    copy), by name: at k>1 each partition's ``pre``, the exchange and each
    partition's ``post``, as ``DistSimulator.run`` steps them.  The same
    step on another copy warms the profiler up."""
    k1 = not isinstance(step, list)
    fns = [step] if k1 else step

    def copies():
        carries = []
        for c, dev in zip([state] if k1 else state, [sim.dev] if k1 else sim.devs):
            carry = {k: v.clone() if torch.is_tensor(v) else v for k, v in c.items()}
            carry["_reduce"] = state_reduce(dev, carry["weights"])
            carries.append(carry)
        return carries

    def one_step(carries):
        if k1:
            fns[0](carries[0])
            return
        halves = [f.pre(c, None) for f, c in zip(fns, carries)]
        delivered, _ = sim._exchange([h[0] for h in halves], [h[1] for h in halves])
        for f, c, h, (act, pre) in zip(fns, carries, halves, delivered):
            f.post(c, h[0], act, pre)

    warm, carries = copies(), copies()
    return count_device_kernels(lambda: one_step(carries), lambda: one_step(warm))


def run_with_step(sim, step, state, steps):
    """``sim.run`` with its step function (a list of them at k>1) replaced
    by ``step``."""
    own = sim._step
    sim._step = step
    try:
        return sim.run(state, steps, record_raster=True)
    finally:
        sim._step = own


def phase_noise_add(ses, seed, card, launches):
    """``step_noise_add`` bit for bit against its plain version on the card:
    2^20 shuffled ids with ids past 2^32 and repeats, four steps, with and
    without a strided bias, over both of erfinv's branches; the full vector
    (``ops.step_noise``, the same kernel at the ids ``0..n-1``) likewise;
    and the main path's own inputs (its ids, a ring slot and the bias column
    of its ``vtx_state``).  Then the main path's steps from its end state
    with the port's own noise (one launch) and through the old chain,
    bit-identical in raster and state (``phase_step_kernels`` counts their
    device kernels after the timed paths); and the kernel's time beside the
    old chain's ops."""
    n = 1 << 20
    x, ids, vtx = noise_add_case(n, card, seed)
    big = small = 0
    edge = math.sqrt(1.0 - math.exp(-5.0))  # w = -log1p(-u^2) >= 5 iff |u| > edge
    for t in (0, 1, 999, 2**31 + 3):
        for bias in (None, vtx[:, 3]):
            before = noise_mod.COUNTER.launches
            got = noise_mod.noise_add_cuda(x, ids, seed, t, 0.8, bias)
            require(noise_mod.COUNTER.launches == before + 1, "noise_add launch count")
            want = ref.step_noise_add_ref(x, ids, seed, t, 0.8, bias)
            require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                    f"noise_add kernel differs from its plain version at step {t} "
                    f"({'with' if bias is not None else 'without'} bias)")
        got = ops.step_noise(seed, t, n, 1.0, device=card)
        want = ref.step_noise_ref(seed, t, n, 1.0, device=card)
        require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                f"ops.step_noise differs from its plain version at step {t}")
        u = ref.noise_uniform_ref(ref.noise_bits_ref(seed, t, n, card)).double().abs()
        big, small = big + int((u > edge).sum()), small + int((u <= edge).sum())
    require(big > 0 and small > 0, f"erfinv branches: {small} below 5, {big} at or above")
    say("noise", f"noise_add kernel: {n} shuffled ids (past 2^32, repeated) at 4 steps, with "
        "and without a strided bias, and the full vector (ops.step_noise) over the ids 0..n-1, "
        f"bit-identical to their plain versions on the card; erfinv's branches taken {small} "
        f"(w < 5) and {big} (w >= 5) times")

    sim = ses.simulator
    n_main = sim.dev.n_p
    ring = ses.state["ring"]
    bias = ses.state["vtx_state"][:, LIF_BIAS]
    ids_m = sim._noise_ids
    sigma = sim.noise_sigma
    for t in (0, 1, STEPS, 2**31 + 3):
        for b_m in (None, bias):
            got = noise_mod.noise_add_cuda(ring[t % sim.d_ring], ids_m, seed, t, sigma, b_m)
            want = ref.step_noise_add_ref(ring[t % sim.d_ring], ids_m, seed, t, sigma, b_m)
            require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                    f"noise_add differs from its plain version on the main path's inputs at "
                    f"step {t} ({'with' if b_m is not None else 'without'} bias)")
    say("noise", f"noise_add on the main path's inputs ({n_main} ids, its ring's slots, the bias "
        f"column of its vtx_state at stride {bias.stride(0)}) at 4 steps, with and without the "
        "bias: bit-identical to its plain version")

    mode0 = sim.gather
    for gather in ("dense", "event"):
        sim.set_gather(gather)
        old = old_chain_step(sim, gather)
        st_new, out_new = sim.run(ses.state, ENGINE_STEPS, record_raster=True)
        st_old, out_old = run_with_step(sim, old, ses.state, ENGINE_STEPS)
        require(torch.equal(out_new["raster"], out_old["raster"])
                and all(torch.equal(st_new[k], st_old[k]) for k in ("vtx_state", "ring", "hist")),
                f"{sim.engine_choice.engine}: the own-noise steps differ from the old chain's")
        say("noise", f"{sim.engine_choice.engine}: {ENGINE_STEPS} steps from the main path's end "
            f"state ({int(out_new['raster'].sum())} spikes) with the port's own noise "
            f"({'noise_add' if gather == 'dense' else 'the step front'}) and through the old "
            "noise chain: raster, vtx_state, ring and hist bit-identical")
    sim.set_gather(mode0)

    # the old chain's full draw: the kernel over the ids 0..n-1 (ops.step_noise)
    neg0 = torch.full((n_main,), -0.0, device=card)
    all_ids = torch.arange(n_main, device=card)
    full = ops.step_noise(seed, STEPS, n_main, sigma, device=card)
    slot = ring[3].clone()
    tk = cuda_ms(lambda: noise_mod.noise_add_cuda(ring[3], ids_m, seed, STEPS, sigma, bias), 200)
    tp = cuda_ms(lambda: ref.step_noise_add_ref(ring[3], ids_m, seed, STEPS, sigma, bias), 10)
    chain = dict(
        clone=cuda_ms(lambda: ring[3].clone(), 200),
        noise=cuda_ms(lambda: noise_mod.noise_add_cuda(neg0, all_ids, seed, STEPS, sigma), 200),
        index_select=cuda_ms(lambda: full.index_select(0, ids_m), 200),
        add=cuda_ms(lambda: slot + full, 200),
        bias_add=cuda_ms(lambda: slot + bias, 200),
    )
    b, by, times = noise_bound(n_main, 20, NOISE_F32_OPS + 2)
    say("timing", f"noise_add n={n_main} with the bias: kernel {tk * 1e3:.2f} us, plain "
        f"{tp * 1e3:.1f} us, bound {b * 1e3:.3f} us ({by}; "
        + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in times.items())
        + f" us: 20 B an id, x, id, bias read and the sum written; {n_main} + 1 ciphers, "
        f"{NOISE_F32_OPS + 2} f32 operations an id); the old chain's ops "
        + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in chain.items())
        + f" us, {sum(chain.values()) * 1e3:.2f} us in all; library: none (torch's generators "
        "are Philox, not Threefry)")
    src, rep = SOURCES["noise_add"]
    return dict(name="noise_add", route="cuda", source=src, replaces=rep, launches=launches,
                max_abs_err=0.0, ms=tk, plain_ms=tp, bound_ms=b, bound_by=by, library_ms=None,
                old_chain_ms=chain, path="main",
                note="not a TPU kernel: the reference draws its noise as jnp, takes the "
                "partition's ids and adds")


def phase_k4_front_host(ses, params):
    """The host time of the k>1 path's step front a step, for its
    ``K_PARTS`` partitions, four stages alternated twice in one process:
    the noise alone, ``step_noise_add`` per partition against the chain it
    replaced (one ``(n_global,)`` draw a step on the first partition's card,
    then per partition the slot's clone, ``index_select``, add and bias
    add); and the whole front, ``step_front`` per partition against the
    chain it replaced (``step_noise_add``, the two column copies,
    ``lif_step``, the two column writes, the uint8 history write).  Host
    clock around ``STEPS`` steps of each with no sync inside; the time to
    the sync after them beside it.  The front stages advance copies of the
    partitions' vtx_state and hist."""
    dsim = ses.simulator
    seed, sigma, D = dsim.cfg.seed, dsim.noise_sigma, dsim.d_ring
    parts = [(c["ring"], c["vtx_state"].clone(), c["hist"].clone(), ids)
             for c, ids in zip(ses.state, dsim._noise_ids)]
    dev0 = parts[0][0].device
    neg0 = torch.full((dsim.n_global,), -0.0, device=dev0)
    all_ids = torch.arange(dsim.n_global, device=dev0)

    def noise_add(t):
        for ring, vtx, _, ids in parts:
            ops.step_noise_add(ring[t % D], ids, seed, t, sigma, vtx[:, LIF_BIAS])

    def noise_chain(t):
        g = noise_mod.noise_add_cuda(neg0, all_ids, seed, t, sigma)
        for ring, vtx, _, ids in parts:
            i_syn = ring[t % D].clone()
            i_syn = i_syn + g.to(ring.device).index_select(0, ids)
            i_syn + vtx[:, LIF_BIAS]

    def front(t):
        for ring, vtx, hist, ids in parts:
            ops.step_front(vtx, ring[t % D], ids, seed=seed, t=t, sigma=sigma, draw=True,
                           bias=True, hist_row=hist[t % D], params=params)

    def chain(t):
        for ring, vtx, hist, ids in parts:
            front_chain(vtx, ring[t % D], ids, hist[t % D], seed, t, sigma, params)

    per = {}
    stages = (("noise chain", noise_chain), ("noise_add", noise_add),
              ("front chain", chain), ("step_front", front))
    for label, fn in stages * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(STEPS):
            fn(t)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        synced = time.perf_counter() - t0
        per.setdefault(label, []).append(f"{host / STEPS * 1e6:.1f} ({synced / STEPS * 1e6:.1f})")
    say("timing", f"k>1 step front, {K_PARTS} partitions of {parts[0][3].numel()} rows, "
        f"{STEPS} steps each (host clock, us/step; to the sync after them in brackets): "
        + "; ".join(f"{k} {', '.join(v)}" for k, v in per.items()))


# -- the step front ----------------------------------------------------------------

# f32 operations of a row's step front besides the noise's: the noise and
# bias adds (2) and lif_advance's (10); the trace variant adds two decays (4)
FRONT_F32_OPS = NOISE_F32_OPS + 2 + 10
# bytes a row: the slot (4), the id (8), v, refrac and bias read (12), v and
# refrac written (8), the spike (4), the history byte (1); the traces read
# and written add 16
FRONT_BYTES, FRONT_TRACE_BYTES = 37, 16


def same_bits(a, b):
    """Bit for bit equal (signed zeros and NaN payloads too)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def front_chain(vtx, slot, ids, hist_row, seed, t, sigma, params, traces=None, taus=None):
    """The chain the step front replaced, on the card, in place on ``vtx``
    and ``hist_row``: ``noise_add`` with the bias, the two column copies,
    ``lif_step`` or ``pre_exchange``, the two column writes, the uint8
    history write.  Returns ``(spikes[, tr_plus', tr_minus'])``."""
    i_in = ops.step_noise_add(slot, ids, seed, t, sigma, vtx[:, LIF_BIAS])
    v, refrac = vtx[:, LIF_V].contiguous(), vtx[:, LIF_REF].contiguous()
    v2, r2, *out = ops.fused_pre_exchange(v, refrac, i_in, *(traces or ()), params=params,
                                          taus=taus)
    vtx[:, LIF_V] = v2
    vtx[:, LIF_REF] = r2
    hist_row.copy_(out[0].to(torch.uint8))
    return tuple(out)


def check_front(what, vtx, slot, ids, hist_row, seed, t, sigma, params, traces=None,
                taus=None):
    """The front's kernel on copies of these operands against its plain
    version, with and without the draw and the bias, and against the chain
    it replaced: spikes, traces, vtx_state and the history row bit for
    bit."""
    tr = dict(tr_plus=traces[0], tr_minus=traces[1], taus=taus) if traces else {}
    for draw, bias in ((True, True), (False, True), (True, False), (False, False)):
        kw = dict(seed=seed, t=t, sigma=sigma, draw=draw, bias=bias, params=params, **tr)
        vk, hk, vp, hp = vtx.clone(), hist_row.clone(), vtx.clone(), hist_row.clone()
        got = front_mod.step_front_cuda(vk, slot, ids, hist_row=hk, **kw)
        want = ref.step_front_ref(vp, slot, ids, hist_row=hp, **kw)
        require(len(got) == len(want) and all(same_bits(a, b) for a, b in zip(got, want))
                and same_bits(vk, vp) and same_bits(hk, hp),
                f"{what}: step_front (draw={draw}, bias={bias}) differs from its plain version")
        if draw and bias:
            vo, ho = vtx.clone(), hist_row.clone()
            chain = front_chain(vo, slot, ids, ho, seed, t, sigma, params, traces, taus)
            require(all(same_bits(a, b) for a, b in zip(got, chain)) and same_bits(vk, vo)
                    and same_bits(hk, ho), f"{what}: step_front differs from the old chain")
            spikes = int(got[0].sum())
    say("front", f"{what}: step_front on {vtx.shape[0]} rows (vtx_state {tuple(vtx.shape)}, "
        f"{'with' if traces else 'without'} traces) at step {t}, with and without the draw and "
        f"the bias: spikes, {'traces, ' if traces else ''}vtx_state and the history row "
        "bit-identical to its plain version, and to the old chain (noise_add, column copies, "
        f"{'pre_exchange' if traces else 'lif_step'}, column writes, uint8 history) "
        f"({spikes} spikes)")


def front_case(ses, part=None):
    """A path's next step front inputs from its end state: ``(vtx_state,
    ring slot, ids, history row, t)`` of the k=1 carry or of partition
    ``part``, clones."""
    sim = ses.simulator
    carry = ses.state if part is None else ses.state[part]
    ids = sim._noise_ids if part is None else sim._noise_ids[part]
    t = carry["t"]
    slot = t % sim.d_ring
    return (carry["vtx_state"].clone(), carry["ring"][slot].clone(), ids,
            carry["hist"][slot].clone(), t)


def front_engine_ab(tag, sim, gather, state):
    """``ENGINE_STEPS`` steps of ``gather``'s engine from ``state`` through
    the front and through the old chain (``front=False``): raster,
    vtx_state, ring, hist, traces and weights bit-identical.  Returns the
    old chain's step functions and its launch counts."""
    k1 = isinstance(state, dict)
    mode0 = sim.gather
    sim.set_gather(gather)
    engine = sim.engine_choice.engine
    old = sim._make_step(gather, front=False) if k1 else sim._make_steps(gather, front=False)
    reset_counts()
    st_new, out_new = sim.run(state, ENGINE_STEPS, record_raster=True)
    new_launches = read_counts()
    reset_counts()
    st_old, out_old = run_with_step(sim, old, state, ENGINE_STEPS)
    old_launches = read_counts()
    sim.set_gather(mode0)
    require(same_bits(out_new["raster"], out_old["raster"]),
            f"{engine}: the front's raster differs from the old chain's")
    for a, b in zip(*(([x] if k1 else x) for x in (st_new, st_old))):
        for key in ("vtx_state", "ring", "hist", "tr_plus", "tr_minus"):
            require(same_bits(a[key], b[key]), f"{engine}: {key} differs from the old chain's")
        require(all(same_bits(x, y) for x, y in zip(a["weights"], b["weights"])),
                f"{engine}: weights differ from the old chain's")
    k = 1 if k1 else len(state)
    require(new_launches["step_front"] == k * ENGINE_STEPS and all(
        new_launches[n] == 0 for n in ("noise_add", "lif_step", "pre_exchange")),
        f"{engine}: the front's run launched {new_launches}")
    say(tag, f"{engine}: {ENGINE_STEPS} steps from the path's end state "
        f"({int(out_new['raster'].sum())} spikes) through the step front and through the old "
        "chain: raster, vtx_state, ring, hist, traces and weights bit-identical; launches "
        f"{ {n: c for n, c in new_launches.items() if c} } against "
        f"{ {n: c for n, c in old_launches.items() if c} }")
    return old, old_launches


def traced_step(sim, fns, state, marker):
    """``step_kernels`` of one step, traced again (at most three times)
    until the trace holds ``marker``'s kernel once a partition, as the
    launch counters show every step launches it: ``torch.profiler`` has
    dropped launches from a trace on the card, some of them or (once, in
    the k>1 Brunel net's trace) all.  Returns the kernels by name and the
    number of traces taken."""
    k = len(fns) if isinstance(fns, list) else 1
    for attempt in range(1, 4):
        names = step_kernels(sim, fns, state)
        if sum(c for n, c in names.items() if marker in n) == k:
            return names, attempt
    raise AssertionError(f"three traces of one step short of {k} {marker} kernels "
                         f"(torch.profiler saw {sum(names.values())} device kernels): "
                         f"{dict(names)}")


def phase_step_kernels(tag, sim, state, olds):
    """The device kernels of one step of each engine (torch.profiler),
    through the front and through the old chain; ``olds`` maps each gather
    to ``(label, old step functions)`` pairs.  Run after the timed paths of
    the net, so that no timed run follows a profiler session."""
    mode0 = sim.gather
    for gather, chains in olds.items():
        sim.set_gather(gather)
        engine = sim.engine_choice.engine
        front = engine in FRONT_ENGINES
        new, tries = traced_step(sim, sim._step, state, "step_front" if front else "noise_add")
        line = [f"{sum(new.values())} through {'the step front' if front else 'noise_add'}"]
        for label, old in chains:
            k_old, t_old = traced_step(sim, old, state, "noise_add")
            line.append(f"{sum(k_old.values())} through {label}")
            tries += t_old
        stale = [n for n in new if any(w in n for w in ("noise_add", "lif_step", "pre_exchange"))]
        require(not (front and stale), f"{engine}: one step's device kernels {dict(new)}")
        say(tag, f"{engine}: device kernels of one step (torch.profiler, {tries} traces for "
            f"{len(chains) + 1}): " + ", ".join(line) + f"; {dict(new)}")
    sim.set_gather(mode0)


def front_timing(what, vtx, slot, ids, hist_row, seed, t, sigma, params, launches, path,
                 traces=None, taus=None):
    """The front's kernel time (CUDA events) on copies of a path's inputs,
    its plain version's, its bound, and the device time of the chain it
    replaced, as one sequence and op by op."""
    n = vtx.shape[0]
    tr = dict(tr_plus=traces[0], tr_minus=traces[1], taus=taus) if traces else {}
    kw = dict(seed=seed, t=t, sigma=sigma, draw=True, bias=True, params=params, **tr)
    vk, hk = vtx.clone(), hist_row.clone()
    tk = cuda_ms(lambda: front_mod.step_front_cuda(vk, slot, ids, hist_row=hk, **kw), 200)
    tp = cuda_ms(lambda: ref.step_front_ref(vk, slot, ids, hist_row=hk, **kw), 10)
    chain = cuda_ms(lambda: front_chain(vk, slot, ids, hk, seed, t, sigma, params, traces,
                                        taus), 200)
    i_in = noise_mod.noise_add_cuda(slot, ids, seed, t, sigma, vk[:, LIF_BIAS])
    v, refrac = vk[:, LIF_V].contiguous(), vk[:, LIF_REF].contiguous()
    if traces is None:
        lif = lif_mod.lif_step_cuda(v, refrac, i_in, params=params)
        advance = ("lif_step", lambda: lif_mod.lif_step_cuda(v, refrac, i_in, params=params))
    else:
        lif = split_mod.pre_exchange_cuda(v, refrac, i_in, *traces, params=params, taus=taus)
        advance = ("pre_exchange", lambda: split_mod.pre_exchange_cuda(
            v, refrac, i_in, *traces, params=params, taus=taus))
    ops_ms = {
        "noise_add": cuda_ms(lambda: noise_mod.noise_add_cuda(slot, ids, seed, t, sigma,
                                                              vk[:, LIF_BIAS]), 200),
        "two column copies": cuda_ms(lambda: (vk[:, LIF_V].contiguous(),
                                              vk[:, LIF_REF].contiguous()), 200),
        advance[0]: cuda_ms(advance[1], 200),
        "two column writes": cuda_ms(lambda: (vk[:, LIF_V].copy_(lif[0]),
                                              vk[:, LIF_REF].copy_(lif[1])), 200),
        "uint8 history write": cuda_ms(lambda: hk.copy_(lif[2].to(torch.uint8)), 200),
    }
    per_row = FRONT_BYTES + (FRONT_TRACE_BYTES if traces else 0)
    b, by, times = noise_bound(n, per_row, FRONT_F32_OPS + (4 if traces else 0))
    say("timing", f"step_front {what}, n={n}{' with traces' if traces else ''}: kernel "
        f"{tk * 1e3:.2f} us, plain {tp * 1e3:.1f} us, bound {b * 1e3:.3f} us ({by}; "
        + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in times.items())
        + f" us: {per_row} B a row, {n} + 1 ciphers); the chain it replaced "
        f"{chain * 1e3:.2f} us as one sequence, op by op "
        + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in ops_ms.items())
        + f" us, {sum(ops_ms.values()) * 1e3:.2f} us in all; library: none")
    name = "step_front" if traces is None else "step_front_traces"
    src, rep = SOURCES[name]
    return dict(name=name, route="cuda", source=src, replaces=rep, launches=launches,
                max_abs_err=0.0, ms=tk, plain_ms=tp, bound_ms=b, bound_by=by, library_ms=None,
                old_chain_ms=chain, old_chain_ops_ms=ops_ms, path=path)


def _nan_rows(x):
    """The rows (last axis) where ``x`` holds a NaN."""
    return torch.isnan(x).reshape(-1, x.shape[-1]).any(0).nonzero().flatten().tolist()


def phase_nan(card, seed):
    """F3: two NaN weights on silent sources of a small net, one whose
    source is in the target's partition and one whose source is not.  The
    engines record ``row_dot`` for the panels that hold them; each of the
    four kernels, called with that recorded choice on the session's panels,
    takes its row_dot variant and gives NaN in exactly the rows where its
    plain version does."""
    net = microcircuit(scale=0.02, seed=seed + 2)
    d4 = to_dcsr(net, assignment=block_partition(net.n, K_PARTS), uniform=True)
    part = d4.parts[1]
    n_p = part.n
    src = part.col_idx
    own = (src >= n_p) & (src < 2 * n_p)
    row = np.searchsorted(part.row_ptr, np.arange(src.size), side="right") - 1
    remote = int(np.flatnonzero(~own)[0])
    local = int(np.flatnonzero(own & (row != row[remote]))[0])  # another row
    nan_edges = [local, remote]
    part.edge_state[nan_edges, 0] = np.nan
    sources = [int(src[e]) for e in nan_edges]
    rng = np.random.default_rng(seed)
    act_np = (rng.random(d4.n) < 0.1).astype(np.float32)
    act_np[sources] = 0.0  # silent sources
    act = torch.from_numpy(act_np).to(card)

    ses1 = Session(merge_to_single(d4), SimConfig(), device=card)
    sim = ses1.simulator
    dev = sim.dev
    nan_buckets = [b for b, w in enumerate(dev.weights0) if bool(torch.isnan(w).any())]
    require(nan_buckets and all(dev.reduce[b] == "row_dot" for b in nan_buckets)
            and ses1.describe()["reduce"] == dev.reduce, f"recorded reduce {dev.reduce}")
    require(launch_row_dot(dev.reduce, dev.weights0), "the k=1 launches keep row_dot_active")
    cols, weights, row_len = dev.cols, dev.weights0, dev.row_len
    found = {}
    # spike_gather, bucket by bucket
    rows = []
    for b, (c, w, rl) in enumerate(zip(cols, weights, row_len)):
        got = gather_mod.spike_gather_cuda(act, c, w, rl, reduce=dev.reduce[b:b + 1])
        want = ref.spike_gather_ref(act, c, w)
        require(_nan_rows(got) == _nan_rows(want), f"spike_gather NaN rows, bucket {b}")
        rows += _nan_rows(got)
    found["spike_gather"] = rows
    # the event kernel
    ring, slot, write = event_case(sim)
    got, want = ring.clone(), ring.clone()
    event_mod.event_post_exchange_cuda(act, got, slot, write, sim.event_plan, cols, weights,
                                       row_len, reduce=dev.reduce)
    event_mod.event_post_exchange_plain(act, want, slot, write, sim.event_plan, cols, weights)
    require(torch.equal(torch.isnan(got), torch.isnan(want)), "event_post_exchange NaN slots")
    found["event_post_exchange"] = _nan_rows(got)
    # fused_step: the sources held refractory, so they do not spike
    params = lif_params(ses1.net)
    v = dev.vtx_state0[:, LIF_V].contiguous()
    refrac = torch.from_numpy(rng.integers(0, 2, d4.n).astype(np.float32)).to(card)
    refrac[sources] = 2.0
    i_tot = dev.vtx_state0[:, LIF_BIAS] + torch.from_numpy(
        rng.normal(0.0, 4.0, d4.n).astype(np.float32)).to(card)
    got = fused_mod.fused_step_cuda(v, refrac, i_tot, cols, weights, row_len, params=params,
                                    reduce=dev.reduce)
    want = ref.fused_step_ref(v, refrac, i_tot, cols, weights, params=params)
    require(torch.equal(got[2], want[2]), "fused_step spikes differ with a NaN weight")
    rows = []
    for a, b in zip(got[3], want[3]):
        require(_nan_rows(a) == _nan_rows(b), "fused_step NaN rows")
        rows += _nan_rows(a)
    found["fused_step"] = rows
    say("nan", f"microcircuit(0.02) merged, NaN weights on edges {nan_edges} (silent sources "
        f"{sources}): describe()['reduce'] = {ses1.describe()['reduce']}")

    # post_exchange: partition 1 of the k>1 session, whose local sub-panel
    # holds one NaN weight and whose remote sub-panel the other
    ses4 = Session(d4, SimConfig(), engine="spmd", devices=[card] * K_PARTS)
    desc = ses4.describe()
    dsim = ses4.simulator
    p1 = dsim.devs[1]
    require("row_dot" in p1.reduce_local and "row_dot" in p1.reduce_remote
            and "row_dot" in p1.reduce and set(dsim.devs[0].reduce) == {"active"},
            f"recorded reduce {desc}")
    ring, clear, onehot, _, _ = split_case(dsim, STEPS, 13)
    act_local = act[n_p:2 * n_p].contiguous()
    rows = {}
    for what, a, cl, c, w, rl, red in (
        ("full", act, clear, p1.cols, p1.weights0, p1.row_len, p1.reduce),
        ("local", act_local, clear, p1.cols_local, p1.weights_local, p1.row_len_local,
         p1.reduce_local),
        ("remote", act, None, p1.cols_remote, p1.weights_remote, p1.row_len_remote,
         p1.reduce_remote),
    ):
        require(launch_row_dot(red, w), f"post_exchange {what} pass keeps row_dot_active")
        got = split_mod.post_exchange_cuda(a, ring, cl, onehot, c, w, rl, reduce=red)
        want = (ref.fused_post_exchange_remote_ref(a, ring, onehot, c, w) if cl is None
                else ref.fused_post_exchange_ref(a, ring, cl, onehot, c, w))
        require(torch.equal(torch.isnan(got), torch.isnan(want)), f"post_exchange {what} NaN")
        rows[what] = _nan_rows(got)
    found["post_exchange"] = rows
    for name, got in found.items():
        require(any(got.values()) if isinstance(got, dict) else bool(got),
                f"{name}: no NaN row, the NaN weight was skipped")
    say("nan", f"k={K_PARTS}, partition 1: reduce {p1.reduce}, local {p1.reduce_local}, remote "
        f"{p1.reduce_remote} (partition 0, no NaN: {dsim.devs[0].reduce})")
    say("nan", "each kernel took its row_dot variant from the recorded choice and gives NaN in "
        f"exactly the plain version's rows: {found}")


# -- the plastic path ----------------------------------------------------------

def stdp_taus(sim):
    return sim.stdp_params["tau_plus"], sim.stdp_params["tau_minus"]


def phase_plastic_kernels(sim, params, rng):
    """The plastic kernels against their plain versions, and the fused one
    against the unfused engine's kernels, on the session's own panels.  The
    membranes are drawn up to 2 mV above threshold and the input current
    carries sigma-5 noise, so that many neurons spike and the STDP terms of
    both signs are exercised."""
    dev, n_p = sim.device, sim.dev.n_p
    stdp, taus, dt = sim.stdp_params, stdp_taus(sim), params["dt"]
    vtx = sim.dev.vtx_state0
    lo, hi = params["v_reset"], params["v_thresh"] + 2.0
    v = torch.from_numpy((lo + (hi - lo) * rng.random(n_p)).astype(np.float32)).to(dev)
    refrac = torch.from_numpy(rng.integers(0, 3, n_p).astype(np.float32)).to(dev)
    i_tot = vtx[:, LIF_BIAS] + torch.from_numpy(
        rng.normal(0.0, 5.0, n_p).astype(np.float32)).to(dev)
    tp, tm = (torch.from_numpy(rng.random(n_p).astype(np.float32)).to(dev) for _ in range(2))
    cols, weights, plastic = sim.dev.cols, sim.dev.weights0, sim.dev.plastic
    R = cols[0].shape[0]

    # the unfused engine: lif_step, the trace decays as torch ops, then per
    # bucket spike_gather and stdp_update
    v1, r1, s1 = lif_mod.lif_step_cuda(v, refrac, i_tot, params=params)
    tp1 = ref.trace_decay_ref(tp, s1, dt=dt, tau=taus[0])
    tm1 = ref.trace_decay_ref(tm, s1, dt=dt, tau=taus[1])
    post_t = torch.nn.functional.pad(tm1, (0, R - n_p))
    post_s = torch.nn.functional.pad(s1, (0, R - n_p))
    stdp_args = (tp1, s1, post_t, post_s)
    unfused_w, changed = [], 0
    for c, w, pm, d in zip(cols, weights, plastic, sim.dev.delays):
        got = stdp_mod.stdp_update_cuda(w, pm, c, *stdp_args, params=stdp)
        want = stdp_mod.stdp_update_plain(w, pm, c, *stdp_args, params=stdp)
        require(torch.equal(got, want), f"stdp_update d={d} differs from its plain version")
        changed += int((got != w).sum())
        unfused_w.append(got)
    require(changed > 0, "stdp_update changed no weight")
    say("plastic", f"stdp_update, {len(cols)} buckets of {tuple(cols[0].shape)}: bit-exact vs "
        f"plain ({int(s1.sum())} of {n_p} neurons spike, {changed} slots change)")

    out = fused_mod.fused_step_plastic_cuda(v, refrac, i_tot, tp, tm, cols, weights, plastic,
                                            params=params, taus=taus, stdp=stdp)
    names = ("v", "refrac", "spikes", "tr_plus", "tr_minus")
    for name, a, b in zip(names, out[:5], (v1, r1, s1, tp1, tm1)):
        require(torch.equal(a, b), f"fused_step_plastic {name} differs from the unfused engine's")
    for cur, nw, c, w, uw in zip(out[5], out[6], cols, weights, unfused_w):
        require(torch.equal(cur, gather_mod.spike_gather_cuda(s1, c, w)),
                "fused_step_plastic currents differ from the spike_gather kernel's")
        require(torch.equal(nw, uw), "fused_step_plastic weights differ from stdp_update's")
    want = fused_mod.fused_step_plastic_plain(v, refrac, i_tot, tp, tm, cols, weights, plastic,
                                              params=params, taus=taus, stdp=stdp)
    for name, a, b in zip(names, out[:5], want[:5]):
        require(torch.equal(a, b), f"fused_step_plastic {name} differs from its plain version")
    for a, b in zip(out[6], want[6]):
        require(torch.equal(a, b), "fused_step_plastic weights differ from its plain version")
    err = 0.0
    for a, b in zip(out[5], want[5]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        err = max(err, float((a - b).abs().max()))
    say("plastic", "fused_step_plastic: bit-exact vs lif_step + trace decay + spike_gather + "
        "stdp_update kernels, and vs its plain version in spikes, v, refrac, traces and "
        f"weights; currents max |kernel - plain| = {err:.3e} (rtol=atol=1e-5)")
    inputs = dict(v=v, refrac=refrac, i_tot=i_tot, tp=tp, tm=tm, stdp_args=stdp_args)
    return inputs, {"stdp_update": 0.0, "fused_plastic_step": err}


def check_learned(sim, weights):
    """Plastic slots changed and stay within [w_min, w_max]; every other
    slot (non-plastic or padding) keeps its initial bits.  Returns the
    count of changed slots."""
    stdp = sim.stdp_params
    changed = 0
    for w, w0, pm in zip(weights, sim.dev.weights0, sim.dev.plastic):
        fixed = pm == 0
        require(torch.equal(w[fixed], w0[fixed]), "a non-plastic or padding slot changed")
        pw = w[pm > 0]
        require(bool(torch.isfinite(pw).all()) and float(pw.min()) >= stdp["w_min"]
                and float(pw.max()) <= stdp["w_max"], "a plastic weight left [w_min, w_max]")
        changed += int((w != w0).sum())
    require(changed > 0, "no plastic slot changed: the net never learned")
    return changed


def phase_plastic_path(ses, n):
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    res, rate, raster, secs = run_session(ses, STEPS)
    launches = read_counts()
    chunks = len(res.chunks)
    say("plastic", f"chunks {res.chunks}, gather modes {ses.last_gather_modes}")
    require(ses.engine_choice.engine == "fused_plastic", f"engine {ses.engine_choice}")
    require(ses.last_gather_modes == ("dense",) * chunks, "a plastic chunk left the dense gather")
    require(launches == only(fused_plastic_step=STEPS, noise_add=STEPS),
            f"plastic path launches {launches}")
    counts = res.spike_count
    require(counts.shape == (STEPS,) and np.isfinite(rate.rates).all(), "bad spike counts")
    require(int(counts.sum()) > 0, "the plastic net never spiked")
    require(raster.raster.shape == (STEPS, n), f"raster {raster.raster.shape}")
    require(int(raster.raster.sum()) == int(counts.sum()), "raster and counts disagree")
    st = ses.state
    require(all(bool(torch.isfinite(st[k]).all()) for k in ("tr_plus", "tr_minus", "vtx_state")),
            "non-finite state")
    changed = check_learned(ses.simulator, st["weights"])
    peak = torch.cuda.max_memory_allocated()
    say("plastic", f"{STEPS} steps on 'fused_plastic': {secs:.3f} s, {secs / STEPS * 1e6:.1f} "
        "us/step (host clock, monitors included)")
    say("plastic", f"launches {launches}; spikes: {int(counts.sum())} "
        f"({counts.mean() / n:.6f} per neuron a step); mean rate {rate.rates.mean():.2f} Hz; "
        f"{changed} weight slots changed, non-plastic and padding slots unchanged; peak device "
        f"memory {peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated)")
    return raster.raster, launches


def phase_plastic_parity(net, main_raster):
    """256 steps of the unfused engine against a fresh fused_plastic run."""
    unf = Session(net, SimConfig(fused=False))
    require(unf.engine_choice.engine == "unfused", f"engine {unf.engine_choice}")
    nd = len(unf.simulator.dev.cols)
    reset_counts()
    _, _, r_u, secs = run_session(unf, PARITY_STEPS)
    launches = read_counts()
    require(launches == only(lif_step=PARITY_STEPS, spike_gather=PARITY_STEPS * nd,
                             stdp_update=PARITY_STEPS * nd, noise_add=PARITY_STEPS),
            f"unfused plastic path launches {launches}")
    fus = Session(net, SimConfig())
    _, _, r_f, _ = run_session(fus, PARITY_STEPS)
    require(np.array_equal(r_u.raster, r_f.raster), "unfused raster differs from fused_plastic's")
    require(np.array_equal(r_f.raster, main_raster[:PARITY_STEPS]),
            "fresh fused_plastic raster differs from the plastic path's")
    for key in ("vtx_state", "ring", "hist", "tr_plus", "tr_minus"):
        require(torch.equal(unf.state[key], fus.state[key]), f"unfused {key} differs")
    for a, b in zip(unf.state["weights"], fus.state["weights"]):
        require(torch.equal(a, b), "unfused weights differ from fused_plastic's")
    changed = check_learned(unf.simulator, unf.state["weights"])
    say("plastic", f"unfused {PARITY_STEPS} steps: raster, v, ring, traces and weights "
        f"bit-identical to fused_plastic's ({int(r_u.raster.sum())} spikes, {changed} slots "
        f"changed); {secs / PARITY_STEPS * 1e6:.1f} us/step; launches {launches}")
    return unf, fus, launches


def phase_plastic_small_net(seed):
    """A small plastic net on the card against the plain versions on the
    CPU, with the same numpy noise.  Up to 1% of the spikes may differ (the
    gather sums in another order on the card)."""
    small = to_dcsr(balanced_ei(n=2000, stdp=True, seed=seed + 1), k=1)
    sigma = float(small.meta["noise_sigma"])
    noise = (sigma * np.random.default_rng(4).normal(0.0, 1.0, (PARITY_STEPS, small.n))
             ).astype(np.float32)
    rasters, weights = [], []
    for device in ("cuda", "cpu"):
        s = Session(small, SimConfig(fused=True), device=device, _noise_fn=lambda t: noise[t])
        mon = RasterMonitor()
        s.run(PARITY_STEPS, monitors=[mon])
        rasters.append(mon.raster)
        weights.append([w.cpu() for w in s.state["weights"]])
    spikes = int(rasters[0].sum())
    n_diff = int((rasters[0] != rasters[1]).sum())
    w_err = max(float((a - b).abs().max()) for a, b in zip(*weights))
    say("plastic", f"balanced_ei(2000), {PARITY_STEPS} steps, card vs CPU plain versions: "
        f"{spikes} vs {int(rasters[1].sum())} spikes, {n_diff} raster entries differ, "
        f"max |weight difference| {w_err:.3e}")
    require(spikes > 0, "small plastic net never spiked")
    require(n_diff <= 0.01 * spikes, "card and CPU rasters disagree on the small plastic net")


def phase_plastic_timing(sim, params, inputs, errs, launches):
    v, refrac, i_tot, tp, tm = (inputs[k] for k in ("v", "refrac", "i_tot", "tp", "tm"))
    stdp_args = inputs["stdp_args"]
    n_p = sim.dev.n_p
    cols, weights, plastic = sim.dev.cols, sim.dev.weights0, sim.dev.plastic
    stdp, taus = sim.stdp_params, stdp_taus(sim)
    nd, R = len(cols), cols[0].shape[0]
    slots = sum(c.numel() for c in cols)
    out = []

    s_k = s_p = s_b = 0.0
    for c, w, pm in zip(cols, weights, plastic):
        tk = cuda_ms(lambda c=c, w=w, pm=pm: stdp_mod.stdp_update_cuda(
            w, pm, c, *stdp_args, params=stdp), 50)
        tp_ = cuda_ms(lambda c=c, w=w, pm=pm: stdp_mod.stdp_update_plain(
            w, pm, c, *stdp_args, params=stdp), 5)
        # col, weight and mask read and the weight written: 16 bytes a
        # slot, plus the two presynaptic and two postsynaptic vectors
        nb = c.numel() * 16 + 2 * n_p * 4 + 2 * R * 4
        b, _ = bound_ms(nb, 6 * c.numel())
        s_k, s_p, s_b = s_k + tk, s_p + tp_, s_b + b
    say("timing", f"stdp_update, {nd} launches of {tuple(cols[0].shape)} (one step): kernel "
        f"{s_k:.4f} ms ({s_k / nd * 1e3:.2f} us a launch), plain {s_p:.3f} ms, bound "
        f"{s_b:.4f} ms ({slots * 16 / s_k / 1e6:.0f} GB/s of slot traffic)")
    out.append(dict(name="stdp_update", ms=s_k, plain_ms=s_p, bound_ms=s_b, bound_by="bytes",
                    library_ms=None, path="plastic_unfused"))

    kw = dict(params=params, taus=taus, stdp=stdp)
    f_bytes = slots * 16 + 10 * 4 * n_p + nd * R * 4
    f_flops = 14 * n_p + 8 * slots
    tk = cuda_ms(lambda: fused_mod.fused_step_plastic_cuda(
        v, refrac, i_tot, tp, tm, cols, weights, plastic, **kw), 50)
    tp_ = cuda_ms(lambda: fused_mod.fused_step_plastic_plain(
        v, refrac, i_tot, tp, tm, cols, weights, plastic, **kw), 5)
    b, by = bound_ms(f_bytes, f_flops)
    say("timing", f"fused_plastic_step ({nd} buckets, {slots} slots): kernel {tk:.4f} ms "
        f"({f_bytes / tk / 1e6:.0f} GB/s), plain {tp_:.3f} ms, bound {b:.4f} ms "
        f"({f_bytes / 1e9:.4f} GB)")
    out.append(dict(name="fused_plastic_step", ms=tk, plain_ms=tp_, bound_ms=b, bound_by=by,
                    library_ms=None, path="plastic"))
    for k in out:
        src, rep = SOURCES[k["name"]]
        k.update(route="cuda", source=src, replaces=rep, launches=launches[k["name"]],
                 max_abs_err=errs[k["name"]])
    return out


def phase_plastic_engines(fused_ses, unfused_ses):
    """Host-clock us/step of both plastic engines from the state the
    plastic path ended in, alternating fused, unfused, fused, unfused."""
    per = {}
    state = fused_ses.state
    for ses in (fused_ses, unfused_ses, fused_ses, unfused_ses):
        sim = ses.simulator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(state, ENGINE_STEPS)
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) / ENGINE_STEPS * 1e6
        per.setdefault(sim.engine_choice.engine, []).append(f"{us:.1f}")
    say("timing", f"plastic engines from the plastic path's state, {ENGINE_STEPS} steps each, "
        "no monitors (host clock): "
        + "; ".join(f"{e} {', '.join(us)} us/step" for e, us in per.items()))


# -- the k>1 paths: K_PARTS partitions on one card ------------------------------

def spmd_session(d, card, share=None, **cfg):
    """``K_PARTS`` partitions of ``d`` on the one card; ``share``, a spmd
    session of the same net, lends its panels (the host build of the
    microcircuit's panels takes minutes)."""
    return Session(d, SimConfig(**cfg), engine="spmd", devices=[card] * K_PARTS, _share=share)


def split_launches(modes, chunks, overlap):
    """Expected counts of a k>1 microcircuit run on the split engines: per
    partition and step one ``step_front`` (noise, bias, LIF, history row),
    then on dense chunks the post-exchange pass (two with an overlap mode:
    local and remote) and on event chunks the local pass (with an overlap
    mode) and the event kernel."""
    dense = sum(c for c, m in zip(chunks, modes) if m == "dense")
    event = sum(c for c, m in zip(chunks, modes) if m == "event")
    two = overlap != "off"
    return only(step_front=K_PARTS * (dense + event),
                post_exchange=K_PARTS * (dense * (2 if two else 1) + event * two),
                event_post_exchange=K_PARTS * event)


def compose_ring(act, ring, clear, onehot, cols, weights, n_p):
    """The reference's ring formulation around the ``spike_gather`` kernel:
    what every post-exchange kernel must give bit for bit."""
    curs = [gather_mod.spike_gather_cuda(act, c, w, reduce=panel_reduce([w]))[:n_p]
            for c, w in zip(cols, weights)]
    return ref._ring_accumulate(ring, clear, onehot, curs)


def local_five_pct(n_p, card):
    """A (n_p,) vector with 5% of a partition's own ids active, for the
    local pass."""
    return (torch.rand(n_p, generator=torch.Generator(card).manual_seed(3), device=card)
            < 0.05).float()


def split_case(dsim, t, seed):
    """A random ring and the slot tables of step ``t`` for partition 0."""
    dev = dsim.devs[0]
    D, card = dsim.d_ring, dev.vtx_state0.device
    ring = torch.from_numpy(np.random.default_rng(seed).normal(
        0.0, 1.0, (D, dev.n_p)).astype(np.float32)).to(card)
    clear_tab, onehot_tab = slot_tables(D, dev.delays, card)
    return ring, clear_tab[t % D], onehot_tab[t % D], t % D, [(t + d) % D for d in dev.delays]


def phase_k4_kernels(dsim, act_np):
    """Rows 6 and 9 (split use) at the k>1 microcircuit's shapes, on
    partition 0's panels and an exchanged spike vector of the main path:
    each kernel bit-exact against the ``spike_gather`` kernel composed with
    the reference's ring formulation, and within rtol=atol=1e-5 of its plain
    version (which sums in another order)."""
    dev, n_p = dsim.devs[0], dsim.devs[0].n_p
    card = dev.vtx_state0.device
    act = torch.from_numpy(act_np.astype(np.float32)).to(card)
    act_local = act[:n_p].contiguous()
    act_remote = act.clone()
    act_remote[:n_p] = 0.0
    # the main-path vector may hold no spike of partition 0's own slice: the
    # local pass is also held at a 5% vector, whose active sources it loads
    five_local = local_five_pct(n_p, card)
    ring, clear, onehot, slot, write = split_case(dsim, STEPS, 7)
    require(dev.reduce == dev.reduce_local == dev.reduce_remote == ("active",) * len(dev.cols),
            f"reduce {dev.reduce}, {dev.reduce_local}, {dev.reduce_remote}")
    cases = [
        ("full pass (overlap off)", act, clear, dev.cols, dev.weights0, dev.row_len, dev.reduce),
        ("local pass", act_local, clear, dev.cols_local, dev.weights_local, dev.row_len_local,
         dev.reduce_local),
        ("local pass, 5% active", five_local, clear, dev.cols_local, dev.weights_local,
         dev.row_len_local, dev.reduce_local),
        ("remote pass", act, None, dev.cols_remote, dev.weights_remote, dev.row_len_remote,
         dev.reduce_remote),
    ]
    err = 0.0
    for what, a, cl, cols, weights, row_len, reduce in cases:
        n_active = sum(gather_traffic(a, c, rl)[1] for c, rl in zip(cols, row_len))
        require(n_active > 0 or what == "local pass",
                f"post_exchange {what}: no slot with an active source, the check is vacuous")
        got = split_mod.post_exchange_cuda(a, ring, cl, onehot, cols, weights, row_len,
                                           reduce=reduce)
        if cl is None:
            want = ref.fused_post_exchange_remote_ref(a, ring, onehot, cols, weights)
        else:
            want = ref.fused_post_exchange_ref(a, ring, cl, onehot, cols, weights)
        forced = split_mod.post_exchange_cuda(a, ring, cl, onehot, cols, weights,
                                              reduce="row_dot")
        require(torch.equal(got.view(torch.int32), forced.view(torch.int32)),
                f"post_exchange {what} differs from its forced row_dot variant")
        in_memory = split_mod.post_exchange_cuda(a, ring, cl, onehot, cols, weights, row_len,
                                                 reduce=reduce, shared_bitmask=False)
        require(torch.equal(got.view(torch.int32), in_memory.view(torch.int32)),
                f"post_exchange {what} differs with the activity tested in device memory")
        exact = compose_ring(a, ring, cl, onehot, cols, weights, n_p)
        require(torch.equal(got.view(torch.int32), exact.view(torch.int32)),
                f"post_exchange {what} differs from spike_gather + the ring formulation")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        e = float((got - want).abs().max())
        err = max(err, e)
        inplace = ring.clone()
        split_mod.post_exchange_cuda(a, inplace, cl, onehot, cols, weights, row_len,
                                     reduce=reduce, out=inplace)
        require(torch.equal(inplace.view(torch.int32), got.view(torch.int32)),
                f"post_exchange {what} differs when written in place")
        say("k4", f"post_exchange {what}, panels {[tuple(c.shape) for c in cols]}, row_len, "
            f"reduce {reduce}, {int(a.sum())} of {a.shape[0]} ids active, {n_active} slots "
            "with an active source: bit-exact (signed zeros too) vs its forced row_dot variant, vs "
            "the activity tested in device memory, vs spike_gather + ring formulation, and in "
            f"place; max |kernel - plain| = {e:.3e} (rtol=atol=1e-5)")
    # the local pass then the remote pass give the full pass's ring to the
    # rounding of the split sum
    two = split_mod.post_exchange_cuda(act_local, ring, clear, onehot, dev.cols_local,
                                       dev.weights_local, dev.row_len_local,
                                       reduce=dev.reduce_local)
    split_mod.post_exchange_cuda(act, two, None, onehot, dev.cols_remote, dev.weights_remote,
                                 dev.row_len_remote, reduce=dev.reduce_remote, out=two)
    full = split_mod.post_exchange_cuda(act, ring, clear, onehot, dev.cols, dev.weights0,
                                        dev.row_len, reduce=dev.reduce)
    torch.testing.assert_close(two, full, rtol=1e-5, atol=1e-5)
    say("k4", "local + remote pass vs the full pass: max |difference| = "
        f"{float((two - full).abs().max()):.3e} (rtol=atol=1e-5; the split sums round "
        "in another order)")

    plan = dsim.event_plans[0]
    e_err = 0.0
    for what, a, s in (("remote pass (no clear)", act_remote, None),
                       ("serialized (clear)", act, slot)):
        got, want, dense = ring.clone(), ring.clone(), ring.clone()
        flags = event_mod.event_post_exchange_cuda(a, got, s, write, plan, dev.cols, dev.weights0,
                                                   dev.row_len, reduce=dev.reduce)
        want_flags = event_mod.event_post_exchange_plain(a, want, s, write, plan, dev.cols,
                                                         dev.weights0)
        require(torch.equal(flags, want_flags), f"split event flags differ from plain ({what})")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        if s is not None:
            dense[s] = 0.0
        for c, w, rl, ws, rb in zip(dev.cols, dev.weights0, dev.row_len, write, dev.reduce):
            dense[ws] += gather_mod.spike_gather_cuda(a, c, w, rl, reduce=(rb,))[:n_p]
        require(torch.equal(got, dense), f"split event ring differs from the dense kernels' "
                f"({what})")
        row_dot = split_mod.post_exchange_cuda(a, ring, None if s is None else clear, onehot,
                                               dev.cols, dev.weights0, reduce="row_dot")
        require(torch.equal(got, row_dot), f"split event ring differs from the row_dot kernel's "
                f"(post_exchange) ({what})")
        e = float((got - want).abs().max())
        e_err = max(e_err, e)
        say("k4", f"event_post_exchange split use, {what}: act ({a.shape[0]},) with "
            f"{int(a.sum())} spikes, ring {tuple(ring.shape)}, {float(flags.float().mean()):.4f} "
            f"of {flags.numel()} (bucket, block) pairs flagged; flags equal plain, ring "
            f"bit-equal to spike_gather's and to post_exchange's row_dot variant, max "
            f"|kernel - plain| "
            f"= {e:.3e} (rtol=atol=1e-5)")
    return {"post_exchange": err, "event_post_exchange_split": e_err}


def phase_k4_main(ses, k1_raster, base):
    """The k>1 microcircuit, 1000 steps of ``SimConfig()``: index exchange,
    overlap ``local``, ``fused_split`` then ``fused_split_event``.  Its
    device memory is counted above ``base``, the bytes held before its
    session was built (the k=1 session's)."""
    reset_counts()
    held = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    res, rate, raster, secs = run_session(ses, STEPS)
    launches = read_counts()
    modes = ses.last_gather_modes
    dsim = ses.simulator
    say("k4", f"chunks {res.chunks}, gather modes {modes}, engine {ses.engine_choice}, "
        f"exchange {dsim.exchange} (cap {dsim.index_cap} ids a partition)")
    require(dsim.exchange == "index" and ses.engine_choice.overlap == "local",
            f"k>1 default resolved to {dsim.exchange}/{ses.engine_choice.overlap}")
    require("event" in modes, "the k>1 path never took the event gather")
    require(launches == split_launches(modes, res.chunks, "local"),
            f"k>1 launches {launches} for gather modes {modes}")
    require(int(res.overflow.sum()) == 0, f"index exchange dropped {int(res.overflow.sum())}")
    require(raster.raster.shape == k1_raster.shape, f"raster {raster.raster.shape}")
    n_diff = int((raster.raster != k1_raster).sum())
    require(n_diff == 0, f"k>1 raster differs from the k=1 run of the merged net in {n_diff} "
            "entries")
    counts = res.spike_count
    peak = torch.cuda.max_memory_allocated() - base
    say("k4", f"{STEPS} steps, {K_PARTS} partitions on one card: {secs:.3f} s, "
        f"{secs / STEPS * 1e6:.1f} us/step (host clock, monitors included); raster identical "
        f"to the k=1 run of the merged net ({int(counts.sum())} spikes); overflow 0")
    say("k4", f"launches {launches}; peak device memory {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated, above the {base / 2**30:.2f} GiB the k=1 session "
        f"holds), {held / 2**30:.2f} GiB of it held before the run (panels, sub-panels, touch "
        "bitmaps, initial state)")
    return raster.raster, launches, secs / STEPS * 1e6


def phase_k4_variants(base, card, default_raster, nd):
    """Short runs of the other split engines on ``base``'s panels, counts set
    to 0 before and read after each, every raster equal to the default's."""
    out = {}
    for label, cfg in (("overlap off", dict(overlap="off")),
                       ("double_buffer", dict(overlap="double_buffer")),
                       ("unfused", dict(fused=False))):
        ses = spmd_session(base.net, card, share=base, **cfg)
        reset_counts()
        res, _, raster, secs = run_session(ses, VARIANT_STEPS)
        launches = read_counts()
        choice = ses.engine_choice
        if choice.fused:
            want = split_launches(ses.last_gather_modes, res.chunks, choice.overlap)
        else:
            want = only(lif_step=K_PARTS * VARIANT_STEPS,
                        spike_gather=K_PARTS * nd * VARIANT_STEPS,
                        noise_add=K_PARTS * VARIANT_STEPS)
        require(launches == want, f"k>1 {label} launches {launches}, expected {want}")
        require(int(res.overflow.sum()) == 0, f"k>1 {label} overflow")
        require(np.array_equal(raster.raster, default_raster[:VARIANT_STEPS]),
                f"k>1 {label} raster differs from the default's")
        say("k4", f"{label} ({choice.engine}, overlap {choice.overlap}, gather modes "
            f"{ses.last_gather_modes}), {VARIANT_STEPS} steps: raster identical to the "
            f"default's; {secs / VARIANT_STEPS * 1e6:.1f} us/step; launches {launches}")
        out[label] = launches
        del ses
    return out


def _csr_from(cols, weights, valid, n, dev):
    """Real synapses of a stacked panel as a CSR matrix (see ``_csr``)."""
    crow = np.concatenate([[0], np.cumsum(valid.sum(axis=1))]).astype(np.int64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(crow), torch.from_numpy(cols[valid].astype(np.int64)),
            torch.from_numpy(weights[valid]), size=(cols.shape[0], n),
            check_invariants=False,
        ).to(dev)


def _csr_of(cols, weights, row_len, n):
    """A device panel's real slots (each row's first ``row_len[r]``) as a
    CSR matrix on the card, for ``torch.sparse.mm`` on the same work."""
    R, K = cols.shape
    live = torch.arange(K, device=cols.device)[None, :] < row_len.long()[:, None]
    crow = torch.zeros(R + 1, dtype=torch.int64, device=cols.device)
    crow[1:] = torch.cumsum(row_len.long(), 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, cols[live].long(), weights[live], size=(R, n),
                                       check_invariants=False)


def post_bytes(cols, n_act, D, n_p):
    """What a post-exchange pass must move: every slot's col and weight, the
    activity, the ring read and written, the slot tables."""
    return sum(c.numel() * 8 for c in cols) + n_act * 4 + 2 * D * n_p * 4 + (len(cols) + 1) * D * 4


def phase_k4_timing(dsim, act_np, errs, launches):
    dev, n_p, n = dsim.devs[0], dsim.devs[0].n_p, dsim.n_global
    card = dev.vtx_state0.device
    D, s = dsim.d_ring, dsim.stacked
    act = torch.from_numpy(act_np.astype(np.float32)).to(card)
    act_local = act[:n_p].contiguous()
    ring, clear, onehot, slot, write = split_case(dsim, STEPS, 7)
    work = ring.clone()

    def time_pass(a, cl, cols, weights, row_len, reduce):
        """The pass on ``a``: its time, its row_dot variant's, its plain
        version's, torch.sparse.mm over the same real slots on the same
        vector, and the bytes and bound of the work it needs."""
        tk = cuda_ms(lambda: split_mod.post_exchange_cuda(a, work, cl, onehot, cols, weights,
                                                          row_len, reduce=reduce, out=work), 20)
        t_dot = cuda_ms(lambda: split_mod.post_exchange_cuda(a, work, cl, onehot, cols, weights,
                                                             reduce="row_dot", out=work), 20)
        if cl is None:
            tp = cuda_ms(lambda: ref.fused_post_exchange_remote_ref(a, ring, onehot, cols,
                                                                    weights), 5)
        else:
            tp = cuda_ms(lambda: ref.fused_post_exchange_ref(a, ring, cl, onehot, cols,
                                                             weights), 5)
        a2 = a[:, None].contiguous()
        lib_p = 0.0
        real = active = moved = 0
        for c, w, rl in zip(cols, weights, row_len):
            csr = _csr_of(c, w, rl, a.shape[0])
            torch.testing.assert_close(torch.sparse.mm(csr, a2)[:n_p, 0],
                                       gather_mod.spike_gather_cuda(a, c, w, rl)[:n_p],
                                       rtol=1e-5, atol=1e-5)
            lib_p += cuda_ms(lambda csr=csr: torch.sparse.mm(csr, a2), 20)
            del csr
            r_, a_, m_ = gather_traffic(a, c, rl)
            real, active, moved = real + r_, active + a_, moved + m_
        # the activity, the ring read and written, the slot tables, row_len
        rest = a.shape[0] * 4 + 2 * D * n_p * 4 + (len(cols) + 1) * D * 4 + len(cols) * 4 * R
        nb = 4 * (real + active) + rest
        b, by = bound_ms(nb, 2 * active)
        b_pad, _ = bound_ms(post_bytes(cols, a.shape[0], D, n_p), 2 * sum(c.numel() for c in cols))
        return dict(ms=tk, ms_row_dot=t_dot, plain_ms=tp, library_ms=lib_p, bound_ms=b,
                    bound_by=by, bound_ms_padded=b_pad, bytes=nb, moved=moved + rest,
                    real=real, active=active, spikes=int(a.sum()), ids=a.shape[0])

    R = dev.cols[0].shape[0]
    lib = 0.0
    for i in range(len(s.delays)):
        csr = _csr_from(s.cols[i][0], s.weights[i][0], s.valid[i][0], n, card)
        a2 = act[:, None].contiguous()
        torch.testing.assert_close(torch.sparse.mm(csr, a2)[:n_p, 0],
                                   gather_mod.spike_gather_cuda(act, dev.cols[i],
                                                                dev.weights0[i])[:n_p],
                                   rtol=1e-5, atol=1e-5)
        lib += cuda_ms(lambda csr=csr, a2=a2: torch.sparse.mm(csr, a2), 20)
        del csr
    passes = {
        "full pass (overlap off)": time_pass(act, clear, dev.cols, dev.weights0, dev.row_len,
                                             dev.reduce),
        "local pass": time_pass(act_local, clear, dev.cols_local, dev.weights_local,
                                dev.row_len_local, dev.reduce_local),
        "local pass, 5% active": time_pass(local_five_pct(n_p, card), clear, dev.cols_local,
                                           dev.weights_local, dev.row_len_local,
                                           dev.reduce_local),
        "remote pass": time_pass(act, None, dev.cols_remote, dev.weights_remote,
                                 dev.row_len_remote, dev.reduce_remote),
    }
    for what, x in passes.items():
        say("timing", f"post_exchange {what}, partition 0 ({x['spikes']} active of "
            f"{x['ids']} ids): kernel {x['ms']:.4f} ms (moves about {x['moved'] / 1e9:.4f} GB: "
            f"{x['moved'] / x['ms'] / 1e6:.0f} GB/s); its row_dot variant {x['ms_row_dot']:.4f} "
            f"ms; plain {x['plain_ms']:.3f} ms; torch.sparse.mm on the same vector "
            f"{x['library_ms']:.4f} ms; bound {x['bound_ms']:.4f} ms ({x['bound_by']}: "
            f"{x['bytes'] / 1e9:.4f} GB = 4 B x {x['real']} real slots' cols + 4 B x "
            f"{x['active']} active slots' weights + activity, ring, slot tables and row_len); "
            f"padded bound {x['bound_ms_padded']:.4f} ms")
    say("timing", f"library: torch.sparse.mm over partition 0's real synapses, both buckets: "
        f"{lib:.3f} ms")
    full, loc, loc5, rem = (passes[k] for k in ("full pass (overlap off)", "local pass",
                                                "local pass, 5% active", "remote pass"))
    out = [dict(name="post_exchange", ms=loc["ms"] + rem["ms"],
                plain_ms=loc["plain_ms"] + rem["plain_ms"],
                bound_ms=loc["bound_ms"] + rem["bound_ms"], bound_by="bytes",
                library_ms=loc["library_ms"] + rem["library_ms"], path="k4_main",
                per="one partition's local + remote pass",
                **{f"{key}_{tag}": x[key] for tag, x in (("local", loc), ("local_5pct", loc5),
                                                          ("remote", rem), ("full_pass", full))
                   for key in ("ms", "ms_row_dot", "plain_ms", "library_ms", "bound_ms",
                               "bound_ms_padded")},
                library_ms_partition=lib)]

    # the event kernel's remote pass (own slice of the activity zeroed) at a
    # spike vector of the main path and at a 5% vector, each beside
    # torch.sparse.mm over partition 0's synapses on the same vector
    plan, nd = dsim.event_plans[0], len(dev.cols)
    five = (torch.rand(n, generator=torch.Generator(card).manual_seed(2), device=card)
            < 0.05).float()
    csrs = [_csr_from(s.cols[i][0], s.weights[i][0], s.valid[i][0], n, card)
            for i in range(len(s.delays))]
    events = {}
    for label, a in (("main-path step", act), ("5% active", five)):
        a = a.clone()
        a[:n_p] = 0.0
        a2 = a[:, None].contiguous()
        lib_a = sum(cuda_ms(lambda csr=csr: torch.sparse.mm(csr, a2), 20) for csr in csrs)
        flags = event_mod.event_post_exchange_cuda(a, work, None, write, plan, dev.cols,
                                                   dev.weights0, dev.row_len,
                                                   reduce=dev.reduce)
        real, active, moved, rows = event_traffic(a, plan, flags, dev.cols, dev.row_len, n_p)
        n_ids = int(a.sum())
        e_bytes = (4 * (real + active) + n * 4 + rows * 12
                   + n_ids * (8 + nd * plan.num_blocks) + flags.numel() * 4)
        t = dict(
            ms=cuda_ms(lambda: event_mod.event_post_exchange_cuda(
                a, work, None, write, plan, dev.cols, dev.weights0, dev.row_len,
                reduce=dev.reduce), 20),
            ms_bitmask_l2=cuda_ms(lambda: event_mod.event_post_exchange_cuda(
                a, work, None, write, plan, dev.cols, dev.weights0, dev.row_len,
                reduce=dev.reduce, shared_bitmask=False), 20),
            library_ms=lib_a,
        )
        t["bound_ms"], t["bound_by"] = bound_ms(e_bytes, 2 * active)
        events[label] = t
        say("timing", f"event_post_exchange split use (remote pass), partition 0, {label} "
            f"({n_ids} remote spikes, {rows} of {nd * n_p} (bucket, row) pairs flagged): "
            f"kernel {t['ms']:.4f} ms, bitmask in L2 {t['ms_bitmask_l2']:.4f} ms; "
            f"torch.sparse.mm on the same vector {lib_a:.4f} ms; moves about "
            f"{moved / 1e9:.4f} GB of panel ({moved / t['ms'] / 1e6:.0f} GB/s); bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {e_bytes / 1e9:.4f} GB = 4 B x {real} "
            f"real slots' cols + 4 B x {active} active slots' weights + activity, ring, "
            "row_len, ids and touch bytes)")
        if label == "main-path step":
            act_remote = a
    del csrs
    tp = cuda_ms(lambda: event_mod.event_post_exchange_plain(act_remote, work, None, write,
                                                             plan, dev.cols, dev.weights0), 5)
    say("timing", f"event_post_exchange split use plain version (main-path step) {tp:.3f} ms")
    em, e5 = events["main-path step"], events["5% active"]
    out.append(dict(name="event_post_exchange_split", ms=em["ms"], plain_ms=tp,
                    bound_ms=em["bound_ms"], bound_by=em["bound_by"],
                    library_ms=em["library_ms"], ms_bitmask_l2=em["ms_bitmask_l2"],
                    ms_5pct=e5["ms"], bound_ms_5pct=e5["bound_ms"],
                    library_ms_5pct=e5["library_ms"], path="k4_main",
                    per="one partition's remote pass",
                    vector="a spike vector of the main path, own slice zeroed; *_5pct: 5% "
                           "active, own slice zeroed"))
    for k in out:
        src, rep = SOURCES[k["name"]]
        k.update(route="cuda", source=src, replaces=rep, max_abs_err=errs[k["name"]],
                 launches=launches["event_post_exchange" if k["name"].startswith("event")
                                   else k["name"]])
    return out


def phase_k4_engines(ses):
    """Host-clock us/step of the split engines from the k>1 path's end state."""
    dsim, per = ses.simulator, {}
    mode0 = dsim.gather
    for mode in ("dense", "event", "dense", "event"):
        dsim.set_gather(mode)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dsim.run(ses.state, ENGINE_STEPS)
        torch.cuda.synchronize()
        per.setdefault(dsim.engine_choice.engine, []).append(
            f"{(time.perf_counter() - t0) / ENGINE_STEPS * 1e6:.1f}")
    dsim.set_gather(mode0)
    say("timing", f"k>1 engines from the k>1 path's state, {ENGINE_STEPS} steps each, overlap "
        "local, no monitors (host clock): "
        + "; ".join(f"{e} {', '.join(us)} us/step" for e, us in per.items()))


def cat_state(ses, key):
    """A k>1 carry's per-partition vectors in the merged labelling."""
    return torch.cat([c[key] for c in ses.state], dim=1 if key in ("ring", "hist") else 0)


def require_plastic_equal(ses4, ses1, what):
    """Raster-driving state of the k>1 plastic run against the k=1 run of
    the merged net: hist, traces and weights bit for bit."""
    n_p = ses4.simulator.stacked.n_p
    for key in ("hist", "tr_plus", "tr_minus"):
        require(torch.equal(cat_state(ses4, key), ses1.state[key]), f"{what}: {key} differs")
    for i, w1 in enumerate(ses1.state["weights"]):
        w4 = torch.cat([c["weights"][i][:n_p] for c in ses4.state])
        require(torch.equal(w4, w1[: w4.shape[0]]), f"{what}: weights of bucket {i} differ")
    v4 = cat_state(ses4, "vtx_state")[:, LIF_V]
    v1 = ses1.state["vtx_state"][:, LIF_V]
    return float((v4 - v1).abs().max())


def plastic_k4_launches(overlap, fused, steps, nd):
    if not fused:
        return only(lif_step=K_PARTS * steps, spike_gather=K_PARTS * nd * steps,
                    stdp_update=K_PARTS * nd * steps, noise_add=K_PARTS * steps)
    local = overlap != "off"
    return only(step_front=K_PARTS * steps, post_exchange=K_PARTS * steps * local,
                post_exchange_plastic=K_PARTS * steps)


def phase_k4_plastic_kernels(dsim, params, rng):
    """Rows 5, 7 and 8 at the k>1 Brunel net's shapes, partition 0."""
    dev, n_p, n = dsim.devs[0], dsim.devs[0].n_p, dsim.n_global
    card = dev.vtx_state0.device
    stdp = dsim.stdp_params
    taus = (stdp["tau_plus"], stdp["tau_minus"])
    lo, hi = params["v_reset"], params["v_thresh"] + 2.0
    v = torch.from_numpy((lo + (hi - lo) * rng.random(n_p)).astype(np.float32)).to(card)
    refrac = torch.from_numpy(rng.integers(0, 3, n_p).astype(np.float32)).to(card)
    i_tot = dev.vtx_state0[:, LIF_BIAS] + torch.from_numpy(
        rng.normal(0.0, 5.0, n_p).astype(np.float32)).to(card)
    tp, tm = (torch.from_numpy(rng.random(n_p).astype(np.float32)).to(card) for _ in range(2))
    got = split_mod.pre_exchange_cuda(v, refrac, i_tot, tp, tm, params=params, taus=taus)
    want = ref.fused_pre_exchange_ref(v, refrac, i_tot, tp, tm, params=params, taus=taus)
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            "pre_exchange differs from its plain version")
    lif = lif_mod.lif_step_cuda(v, refrac, i_tot, params=params)
    require(all(torch.equal(a, b) for a, b in zip(got[:3], lif)),
            "pre_exchange LIF differs from the lif_step kernel")
    say("k4", f"pre_exchange n_p={n_p}: bit-exact vs plain and vs lif_step + trace decay "
        f"({int(got[2].sum())} spikes)")

    # an exchanged activity: partition 0's spikes, then random others
    act = (torch.rand(n, generator=torch.Generator(card).manual_seed(2), device=card)
           < 0.05).float()
    act[:n_p] = got[2]
    pre = torch.rand(n, generator=torch.Generator(card).manual_seed(3), device=card)
    pre[:n_p] = got[3]
    post_t, post_s = got[4], got[2]
    act_remote = act.clone()
    act_remote[:n_p] = 0.0
    ring, clear, onehot, _, _ = split_case(dsim, 9, 11)
    cols, weights, plastic = dev.cols, dev.weights0, dev.plastic
    R = cols[0].shape[0]
    pt, ps = (torch.nn.functional.pad(x, (0, R - n_p)) for x in (post_t, post_s))
    errs = {}
    for name, a, cl in (("post_exchange_plastic", act, clear),
                        ("post_exchange_remote_plastic", act_remote, None)):
        new_ring, new_w = split_mod.post_exchange_plastic_cuda(
            a, act, pre, ring, cl, onehot, post_t, post_s, cols, weights, plastic, stdp=stdp)
        if cl is None:
            want = ref.fused_post_exchange_remote_plastic_ref(
                a, act, pre, ring, onehot, post_t, post_s, cols, weights, plastic, stdp=stdp)
        else:
            want = ref.fused_post_exchange_plastic_ref(
                act, pre, ring, cl, onehot, post_t, post_s, cols, weights, plastic, stdp=stdp)
        exact = compose_ring(a, ring, cl, onehot, cols, weights, n_p)
        require(torch.equal(new_ring.view(torch.int32), exact.view(torch.int32)),
                f"{name} ring differs from spike_gather + the ring formulation")
        torch.testing.assert_close(new_ring, want[0], rtol=1e-5, atol=1e-5)
        changed = 0
        for nw, c, w, pm, pw in zip(new_w, cols, weights, plastic, want[1]):
            require(torch.equal(nw, pw), f"{name} weights differ from the plain version")
            require(torch.equal(nw, stdp_mod.stdp_update_cuda(w, pm, c, pre, act, pt, ps,
                                                              params=stdp)),
                    f"{name} weights differ from the stdp_update kernel")
            changed += int((nw != w).sum())
        require(changed > 0, f"{name} changed no weight")
        errs[name] = float((new_ring - want[0]).abs().max())
        say("k4", f"{name}, {len(cols)} buckets of {tuple(cols[0].shape)}: ring bit-exact vs "
            "spike_gather + ring formulation, weights bit-exact vs plain and vs stdp_update "
            f"({changed} slots change); ring max |kernel - plain| = {errs[name]:.3e} "
            "(rtol=atol=1e-5)")
    errs["pre_exchange"] = 0.0
    inputs = dict(v=v, refrac=refrac, i_tot=i_tot, tp=tp, tm=tm, act=act, act_remote=act_remote,
                  pre=pre, post_t=post_t, post_s=post_s, ring=ring, clear=clear, onehot=onehot)
    return inputs, errs


def phase_k4_plastic_path(ses4, ses1, k1_raster):
    reset_counts()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res, _, raster, secs = run_session(ses4, STEPS)
    launches = read_counts()
    choice, dsim = ses4.engine_choice, ses4.simulator
    nd = len(dsim.devs[0].cols)
    say("k4p", f"engine {choice}, exchange {dsim.exchange}, gather modes "
        f"{ses4.last_gather_modes}")
    require(choice.engine == "fused_split_plastic" and choice.overlap == "local"
            and dsim.exchange == "dense", f"k>1 plastic default resolved to {choice}")
    require(launches == plastic_k4_launches("local", True, STEPS, nd),
            f"k>1 plastic launches {launches}")
    require(np.array_equal(raster.raster, k1_raster),
            "k>1 plastic raster differs from the k=1 run of the merged net")
    dv = require_plastic_equal(ses4, ses1, "k>1 plastic path")
    peak = torch.cuda.max_memory_allocated()
    say("k4p", f"{STEPS} steps, {K_PARTS} partitions on one card: {secs:.3f} s, "
        f"{secs / STEPS * 1e6:.1f} us/step (host clock, monitors included); raster, hist, "
        f"traces and weights bit-identical to the k=1 run of the merged net "
        f"({int(raster.raster.sum())} spikes), max |v difference| {dv:.3e}")
    say("k4p", f"launches {launches}; peak device memory {peak / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated), {held / 2**30:.3f} GiB of it held before the run "
        "(the k=1 plastic sessions' panels and states too)")
    return launches


def phase_k4_plastic_variants(base, card, fus1, k1_raster, nd):
    """256 steps of each other split configuration on ``base``'s panels
    against a fresh k=1 ``fused_plastic`` run of the merged net
    (``fus1``)."""
    out = {}
    for label, cfg in (("overlap off", dict(overlap="off")),
                       ("double_buffer", dict(overlap="double_buffer")),
                       ("index exchange", dict(exchange="index")),
                       ("unfused", dict(fused=False))):
        ses = spmd_session(base.net, card, share=base, **cfg)
        reset_counts()
        res, _, raster, secs = run_session(ses, PARITY_STEPS)
        launches = read_counts()
        choice = ses.engine_choice
        want = plastic_k4_launches(choice.overlap, choice.fused, PARITY_STEPS, nd)
        require(launches == want, f"k>1 plastic {label} launches {launches}, expected {want}")
        require(int(res.overflow.sum()) == 0, f"k>1 plastic {label} overflow")
        require(np.array_equal(raster.raster, k1_raster[:PARITY_STEPS]),
                f"k>1 plastic {label} raster differs from the k=1 plastic path's")
        dv = require_plastic_equal(ses, fus1, f"k>1 plastic {label}")
        say("k4p", f"{label} ({choice.engine}, overlap {choice.overlap}, exchange "
            f"{ses.simulator.exchange}), {PARITY_STEPS} steps: raster, hist, traces and "
            f"weights bit-identical to k=1 fused_plastic's, max |v difference| {dv:.3e}; "
            f"{secs / PARITY_STEPS * 1e6:.1f} us/step; launches {launches}")
        out[label] = launches
        del ses
    return out


def phase_k4_plastic_timing(dsim, params, inputs, errs, launches):
    dev, n_p, n = dsim.devs[0], dsim.devs[0].n_p, dsim.n_global
    stdp = dsim.stdp_params
    taus = (stdp["tau_plus"], stdp["tau_minus"])
    x = inputs
    cols, weights, plastic = dev.cols, dev.weights0, dev.plastic
    D, nd, R = dsim.d_ring, len(cols), cols[0].shape[0]
    slots = sum(c.numel() for c in cols)
    out = []
    tk = cuda_ms(lambda: split_mod.pre_exchange_cuda(x["v"], x["refrac"], x["i_tot"], x["tp"],
                                                     x["tm"], params=params, taus=taus), 200)
    tp = cuda_ms(lambda: ref.fused_pre_exchange_ref(x["v"], x["refrac"], x["i_tot"], x["tp"],
                                                    x["tm"], params=params, taus=taus), 50)
    b, by = bound_ms(40 * n_p, 14 * n_p)
    say("timing", f"pre_exchange n_p={n_p}: kernel {tk * 1e3:.2f} us, plain {tp * 1e3:.2f} us, "
        f"bound {b * 1e3:.3f} us ({40 * n_p} B)")
    out.append(dict(name="pre_exchange", ms=tk, plain_ms=tp, bound_ms=b, bound_by=by,
                    library_ms=None, path="k4_plastic",
                    launches_of="the old chain's run in front_engine_ab: no engine launches "
                    "pre_exchange, the step front took its place"))
    # 16 bytes a slot (col, weight, mask read, weight written), the three
    # global vectors, the post terms, the ring read and written
    nb = slots * 16 + 3 * n * 4 + 2 * n_p * 4 + 2 * D * n_p * 4 + (nd + 1) * D * 4
    b, by = bound_ms(nb, 10 * slots)
    work = x["ring"].clone()
    for name, a, cl in (("post_exchange_remote_plastic", x["act_remote"], None),
                        ("post_exchange_plastic", x["act"], x["clear"])):
        tk = cuda_ms(lambda a=a, cl=cl: split_mod.post_exchange_plastic_cuda(
            a, x["act"], x["pre"], work, cl, x["onehot"], x["post_t"], x["post_s"], cols,
            weights, plastic, stdp=stdp, out=work), 50)
        if cl is None:
            tp = cuda_ms(lambda a=a: ref.fused_post_exchange_remote_plastic_ref(
                a, x["act"], x["pre"], x["ring"], x["onehot"], x["post_t"], x["post_s"], cols,
                weights, plastic, stdp=stdp), 5)
        else:
            tp = cuda_ms(lambda cl=cl: ref.fused_post_exchange_plastic_ref(
                x["act"], x["pre"], x["ring"], cl, x["onehot"], x["post_t"], x["post_s"], cols,
                weights, plastic, stdp=stdp), 5)
        say("timing", f"{name} ({nd} buckets, {slots} slots, partition 0): kernel {tk:.4f} ms "
            f"({nb / tk / 1e6:.0f} GB/s), plain {tp:.3f} ms, bound {b:.4f} ms ({nb / 1e9:.4f} GB)")
        out.append(dict(name=name, ms=tk, plain_ms=tp, bound_ms=b, bound_by=by,
                        library_ms=None,
                        path="k4_plastic" if cl is None else "k4_plastic_overlap_off"))
    for k in out:
        src, rep = SOURCES[k["name"]]
        k.update(route="cuda", source=src, replaces=rep, launches=launches[k["name"]],
                 max_abs_err=errs[k["name"]], per="one partition's launch")
    return out


# -- snapshots: save -> restore -> continue on the card --------------------------

SNAP_ROOT = Path(__file__).resolve().parent / "_snap"  # removed at the end
CKPT_STEPS, CKPT_EVERY, CKPT_KEEP = 512, 128, 2


def host_rss_gib():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def snapshot_bytes(path):
    return sum(f.stat().st_size for f in Path(path).iterdir())


def require_disk(need):
    """Fails, naming the bytes needed, unless the snapshots' file system has
    ``need`` bytes free."""
    SNAP_ROOT.mkdir(exist_ok=True)
    free = shutil.disk_usage(SNAP_ROOT).free
    require(free >= need, f"the snapshots need {need} bytes free under {SNAP_ROOT}; "
            f"{free} are free")


def timed_save(ses, path):
    """``save`` without waiting, then ``wait()``: (the run loop's stall, the
    background write's seconds, bytes on disk)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ses.save(str(path), wait=False)
    stall = time.perf_counter() - t0
    ses.wait()
    write = time.perf_counter() - t0 - stall
    return stall, write, snapshot_bytes(path)


def save_line(what, ses, stall, write, n_bytes, smi):
    return (f"{what} at t={ses.t}: {n_bytes} bytes on disk; save stall {stall:.3f} s "
            f"(state_to_dcsr and host copies), write {write:.3f} s to wait() "
            f"({n_bytes / write / 1e9:.3f} GB/s, fsync {'on' if fsync_enabled() else 'off'}); "
            f"host peak RSS {host_rss_gib():.1f} GiB; {smi}")


def restore_line(ses):
    rs = ses.restore_seconds
    return (f"load_latest_valid {rs['load']:.3f} s, reshard {rs['reshard']:.3f} s, "
            f"Session build (ELL, upload) {rs['build']:.3f} s; engine {ses.engine_choice.engine}"
            f", k={ses.k}; host peak RSS {host_rss_gib():.1f} GiB")


def require_same_bits(a, b, what):
    require(a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)),
            f"{what} differs")


def phase_snapshot_microcircuit(ses, smi):
    """[snap] The main path's session at its current t: ``save`` (fsync on),
    ``Session.restore`` onto the card, then the live session and the
    restored one 200 steps each; rasters, spike counts, ``vtx_state``,
    ``ring``, ``hist`` and the traces bit-equal."""
    part = ses.net.parts[0]
    arrays = {key: getattr(part, key).nbytes for key in BUILD_ARRAYS}
    need = sum(arrays.values()) + sum(ses.state[key].numel() * ses.state[key].element_size()
                                      for key in ("ring", "hist", "tr_plus", "tr_minus"))
    require_disk(need + need // 20)
    path = SNAP_ROOT / "microcircuit"
    t_save = ses.t
    stall, write, n_bytes = timed_save(ses, path)
    say("snap", save_line(f"microcircuit k=1 (n={ses.n}, m={ses.m})", ses, stall, write,
                          n_bytes, smi))
    say("snap", "arrays (GB): " + ", ".join(f"{key} {b / 1e9:.3f}" for key, b in arrays.items()))
    restored = Session.restore(str(path))
    torch.cuda.synchronize()
    say("snap", "Session.restore(path) onto the card: " + restore_line(restored))
    require(restored.t == t_save and restored.device == ses.device, "restored t or device")
    require(restored.describe()["reduce"] == ses.describe()["reduce"], "restored reduce differs")
    for key in ("vtx_state", "ring", "hist", "tr_plus", "tr_minus"):
        require_same_bits(restored.state[key], ses.state[key], f"restored {key}")
    live_res, _, live, live_s = run_session(ses, VARIANT_STEPS)
    res, _, got, secs = run_session(restored, VARIANT_STEPS)
    require(int(live.raster.sum()) > 0, "the live microcircuit never spiked")
    require(np.array_equal(got.raster, live.raster), "restored raster differs from the live one")
    require(np.array_equal(res.spike_count, live_res.spike_count), "spike counts differ")
    for key in ("vtx_state", "ring", "hist", "tr_plus", "tr_minus"):
        require_same_bits(restored.state[key], ses.state[key],
                          f"after {VARIANT_STEPS} steps, {key}")
    say("snap", f"live and restored microcircuit, {VARIANT_STEPS} steps each (gather modes "
        f"{ses.last_gather_modes} and {restored.last_gather_modes}): {int(live.raster.sum())} "
        f"spikes, raster, spike counts, vtx_state, ring, hist and traces bit-equal; "
        f"{live_s / VARIANT_STEPS * 1e6:.1f} and {secs / VARIANT_STEPS * 1e6:.1f} us/step")
    del restored
    ses.close()  # the background writer's thread ends here
    shutil.rmtree(path)


def snapshot_arrays(path):
    """A snapshot's arrays, partitions concatenated: under block partitions
    of one labelling every row and slot keeps its place, so equal arrays
    are equal by permanent id (``global_ids`` is among them)."""
    net, sim_state, t = load_binary(str(path))
    out = {key: np.concatenate([getattr(p, key) for p in net.parts])
           for key in ("global_ids", "col_idx", "edge_state", "vtx_state")}
    for key in ("ring", "hist", "tr_plus", "tr_minus"):
        out[key] = np.concatenate([sim_state[p][key] for p in range(net.k)], axis=-1)
    return t, out


def extract_format_example():
    """``docs/FORMAT.md``'s NumPy-only reader, taken as
    ``tests/test_format_doc.py`` takes it."""
    text = (Path(__file__).resolve().parent / "docs" / "FORMAT.md").read_text()
    blocks = [b for b in re.findall(r"```python\n(.*?)```", text, flags=re.DOTALL)
              if "sys.argv[1]" in b]
    require(len(blocks) == 1 and "repro" not in blocks[0], "FORMAT.md's example script")
    return blocks[0]


def phase_snapshot_brunel(ses4, card, smi):
    """[snap] The k=4 Brunel session on one card: ``save``, then
    ``Session.restore`` at k=4, 2 and 1, 256 steps each against the live
    session's own 256 (rasters, synced weights, traces and hist bit-equal;
    ``vtx_state`` and ``ring`` bit-equal at k=4, and at k=2 and 1 equal to
    the rounding of the split engines' local-then-remote sums, whose
    largest differences are printed, as in phase 13); then ``run(512, checkpoint_every=128,
    max_to_keep=2)`` against a run without checkpoints, retention, and
    ``Session(root)``; then FORMAT.md's NumPy reader on the snapshot."""
    need = 4 * sum(getattr(p, key).nbytes for p in ses4.net.parts for key in BUILD_ARRAYS)
    require_disk(need)
    path = SNAP_ROOT / "brunel"
    t_save = ses4.t
    stall, write, n_bytes = timed_save(ses4, path)
    say("snap", save_line(f"Brunel k={K_PARTS} spmd (n={ses4.n}, m={ses4.m})", ses4, stall,
                          write, n_bytes, smi))
    _, _, live, _ = run_session(ses4, PARITY_STEPS)
    ses4.save(str(SNAP_ROOT / "brunel_live"))
    t_end, want = snapshot_arrays(SNAP_ROOT / "brunel_live")
    require(int(live.raster.sum()) > 0, "the live Brunel net never spiked")
    restored4 = None
    for k in (K_PARTS, 2, 1):
        place = dict(engine="spmd", devices=[card] * k) if k > 1 else dict(device=card)
        ses = Session.restore(str(path), k=k, **place)
        torch.cuda.synchronize()
        require(ses.t == t_save and ses.k == k, f"restored at k={k}: t={ses.t}, k={ses.k}")
        _, _, got, secs = run_session(ses, PARITY_STEPS)
        require(np.array_equal(got.raster, live.raster),
                f"k={k} raster differs from the live one")
        ses.save(str(SNAP_ROOT / f"brunel_k{k}"))
        t_k, arrs = snapshot_arrays(SNAP_ROOT / f"brunel_k{k}")
        require(t_k == t_end, f"k={k}: t {t_k} != {t_end}")
        # the ring and v hold sums of a row's local then remote sources:
        # bit-equal at the live run's k, equal to that rounding at another
        summed = () if k == K_PARTS else ("ring", "vtx_state")
        for key in want:
            if key not in summed:
                require(arrs[key].dtype == want[key].dtype and np.array_equal(
                    arrs[key].view(np.uint8), want[key].view(np.uint8)), f"k={k}: {key} differs")
        require(np.array_equal(arrs["vtx_state"][:, 1:], want["vtx_state"][:, 1:]),
                f"k={k}: refractory or bias columns differ")
        dv = float(np.abs(arrs["vtx_state"] - want["vtx_state"]).max())
        dr = float(np.abs(arrs["ring"] - want["ring"]).max())
        say("snap", f"Session.restore(path, k={k}): {restore_line(ses)}; {PARITY_STEPS} steps "
            f"{secs / PARITY_STEPS * 1e6:.1f} us/step; raster ({int(got.raster.sum())} spikes), "
            f"synced weights, traces, hist{', ring, vtx_state' if k == K_PARTS else ''} "
            f"bit-equal to the live k={K_PARTS} run by permanent id; max |v difference| "
            f"{dv:.3e}, max |ring difference| {dr:.3e}")
        if k == K_PARTS:
            restored4 = ses
        del ses
    del want

    root = SNAP_ROOT / "ckpt"
    t0 = ses4.t
    ckpt_mon = RasterMonitor()
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    ses4.run(CKPT_STEPS, monitors=[ckpt_mon], checkpoint_every=CKPT_EVERY,
             checkpoint_dir=str(root), max_to_keep=CKPT_KEEP)
    run_s = time.perf_counter() - t_run
    ses4.wait()
    plain = RasterMonitor()
    restored4.run(CKPT_STEPS, monitors=[plain])
    require(np.array_equal(ckpt_mon.raster, plain.raster),
            "the checkpointed run's raster differs from a run without checkpoints")
    steps = snapshot_steps(str(root))
    want_steps = [t0 + CKPT_STEPS - CKPT_EVERY * i for i in range(CKPT_KEEP)][::-1]
    require(steps == want_steps and len(list(root.iterdir())) == CKPT_KEEP,
            f"step dirs {sorted(p.name for p in root.iterdir())}, want {want_steps}")
    resumed = Session(str(root), engine="spmd", devices=[card] * K_PARTS)
    require(resumed.t == ses4.t, f"Session(root) resumed at {resumed.t}, not {ses4.t}")
    for p, (a, b) in enumerate(zip(resumed.state, ses4.state)):
        for key in ("vtx_state", "ring", "hist", "tr_plus", "tr_minus"):
            require_same_bits(a[key], b[key], f"Session(root) partition {p} {key}")
        for wa, wb in zip(a["weights"], b["weights"]):
            require_same_bits(wa, wb, f"Session(root) partition {p} weights")
    stalls = ses4.last_ckpt_stalls
    say("snap", f"run({CKPT_STEPS}, checkpoint_every={CKPT_EVERY}, max_to_keep={CKPT_KEEP}) on "
        f"the live k={K_PARTS} session: {run_s / CKPT_STEPS * 1e6:.1f} us/step with the "
        f"checkpoints; last_ckpt_stalls {[round(x, 4) for x in stalls]} s; raster equal to a run "
        f"without checkpoints ({int(plain.raster.sum())} spikes); step dirs {steps}; "
        f"Session(root) resumed at t={resumed.t} (load_latest_valid "
        f"{resumed.restore_seconds['load']:.3f} s), every carry array bit-equal; {smi}")
    del resumed, restored4
    ses4.close()

    script = SNAP_ROOT / "read_shard.py"
    script.write_text(extract_format_example())
    env = {key: v for key, v in os.environ.items() if key != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script), str(path)], capture_output=True,
                         text=True, env=env, cwd=str(SNAP_ROOT), timeout=300)
    require(out.returncode == 0 and f"OK: partition 0 of {K_PARTS}" in out.stdout,
            f"FORMAT.md's reader on the card's snapshot: {out.stdout} {out.stderr}")
    say("snap", "docs/FORMAT.md's NumPy-only reader (no package on the path) on the snapshot "
        "the card wrote: " + out.stdout.strip().splitlines()[-1])


# -- procedural construction ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def keystream_sass():
    """The built keystream kernel's item loop, read from the library's SASS
    with ``cuobjdump``: G ciphers (``kPairs`` of ``csrc/keystream.cu``), the
    item's row load and stores.  Fails unless the loop holds exactly G
    ciphers' 20 rotates (either form) and 20 xors, with each multiply-form
    rotate's OR folded into a xor.  Returns a dict: ``g``; ``body`` and
    ``pipes``, the loop's instructions in all and by pipe; the rotates
    (``shf``, ``wide``), ``xors``, ``folded`` and ``adds`` by opcode; and
    ``per_cipher``, a cipher's instructions by pipe (its rotates and xors and
    the loop's adds, over G; an IMAD.WIDE counts twice on the FMA pipe) and
    to dispatch."""
    src = (Path(__file__).resolve().parent / SOURCES["keystream"][0]).read_text()
    g = int(re.search(r"constexpr int kPairs = (\d+);", src).group(1))
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(_build.build().path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    funcs = [f for f in re.split(r"\n\s*Function : ", sass)[1:]
             if "keystream_kernel" in f.split("\n", 1)[0]]
    require(len(funcs) == 1, f"{len(funcs)} keystream kernels in the SASS")
    code = []  # (address, opcode, operands)
    for line in funcs[0].splitlines():
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);", line)
        if m:
            code.append((int(m.group(1), 16), m.group(2), m.group(3)))
    loops = [(int(re.findall(r"0x[0-9a-f]+", args)[-1], 16), at) for at, op, args in code
             if op.split(".")[0] == "BRA" and re.findall(r"0x[0-9a-f]+", args)]
    loops = [(lo, hi) for lo, hi in loops if lo < hi]
    require(len(loops) == 1, f"keystream SASS: {len(loops)} backward branches")
    lo, hi = loops[0]
    body = [(op, args) for at, op, args in code if lo <= at <= hi]

    pipes = Counter(SASS_PIPES.get(op.split(".")[0], "other") for op, _ in body)
    shf = sum(op.startswith("SHF.L.W") for op, _ in body)
    # a multiply-form rotate: the product of a register and a multiplier
    # from the kernel's arguments (uniform register or constant bank), plus 0
    wide = sum(op.startswith("IMAD.WIDE.U32") and args.rstrip().endswith("RZ")
               and re.search(r"UR\d+|c\[0x0\]", args) is not None for op, args in body)
    xors = folded = 0
    for op, args in body:
        if op.startswith("LOP3"):
            table = re.findall(r"0x[0-9a-f]+", args)[-1]
            xors += table in LUT_XOR | LUT_OR_XOR
            folded += table in LUT_OR_XOR
    adds = Counter(op for op, _ in body if op in SASS_ADDS)
    require(shf + wide == 20 * g and xors == 20 * g and folded == wide,
            f"keystream SASS loop: {shf} + {wide} rotates, {xors} xors ({folded} folded), "
            f"not {g} ciphers' {20 * g} and {20 * g} with every product folded")
    add_on = Counter()
    for op, n in adds.items():
        add_on[SASS_ADDS[op]] += n
    per_cipher = dict(alu=(shf + xors + add_on["alu"]) / g, fma=(2 * wide + add_on["fma"]) / g,
                      dispatch=(shf + wide + xors + sum(adds.values())) / g)
    return dict(g=g, body=len(body), pipes=dict(pipes), shf=shf, wide=wide, xors=xors,
                folded=folded, adds=dict(adds), per_cipher=per_cipher)


def cipher_ms(ciphers):
    """The least time of ``ciphers`` Threefry ciphers' operations: each
    cipher's 67 over both integer pipes at once."""
    return ciphers * CIPHER_INT_OPS / DISPATCH_PER_S * 1e3


def sass_ms(ciphers):
    """A diagnostic of the built keystream kernel: the ALU pipe's, the FMA
    pipe's and the dispatch time of ``ciphers`` ciphers at its loop's
    per-cipher counts (``keystream_sass``)."""
    c = keystream_sass()["per_cipher"]
    return dict(alu=ciphers * c["alu"] / INT32_ALU_OPS_PER_S * 1e3,
                fma=ciphers * c["fma"] / INT32_FMA_OPS_PER_S * 1e3,
                dispatch=ciphers * c["dispatch"] / DISPATCH_PER_S * 1e3)


def bound_of(times):
    """(ms, "bytes" or "operations") of the largest of ``times``."""
    what = max(times, key=times.get)
    return times[what], "bytes" if what == "bytes" else "operations"


def keystream_bound(n_rows, j0, n_words):
    """(ms, what bounds it, bytes, ciphers, times) of one keystream call: the
    larger of the counters read once and the words written once over the
    HBM rate, and the ciphers' integer operations (``cipher_ms``), one
    cipher per counter pair the call touches."""
    pairs = ((j0 + n_words - 1) >> 1) - (j0 >> 1) + 1 if n_words else 0
    n_bytes = n_rows * 8 + n_rows * n_words * 4
    times = dict(bytes=n_bytes / HBM_BYTES_PER_S * 1e3, int32=cipher_ms(n_rows * pairs))
    return (*bound_of(times), n_bytes, n_rows * pairs, times)


def keystream_cases(seed):
    """The p1 inputs: (label, stream, rows, j0, n_words)."""
    rng = np.random.default_rng(seed)
    gathered = rng.integers(0, 2**31, 200_000, dtype=np.int64)
    gathered[::7] = gathered[3]  # repeats
    gathered[-5:] = 2**31 - 1
    return [
        ("bound on the build's calls", crng.rule_stream(6, crng.WEIGHT_OFF),
         np.arange(KS_ROWS, dtype=np.int64) + 20683, 0, KS_WORDS),
        ("largest call of the build", crng.rule_stream(0, crng.WEIGHT_OFF),
         np.arange(KS_REAL_R0, KS_REAL_R0 + KS_ROWS, dtype=np.int64), 0, KS_REAL_WORDS),
        ("odd j0 and odd n_words", crng.rule_stream(3, crng.SRC_OFF),
         rng.integers(0, 77169, 5000, dtype=np.int64), 3, 1001),
        ("gathered ids with repeats up to 2^31-1", crng.STREAM_COORD, gathered, 0, 4),
        # the work items' edges: rows not a multiple of a block's items,
        # pairs not a multiple of G, odd j0 with an odd tail, one and two
        # words a row, counters up to 2^32-1, words up to 2^32
        ("one word a row, odd j0", crng.STREAM_V, gathered[:4097], 1, 1),
        ("two words a row, odd j0", crng.STREAM_V, gathered[:4097], 5, 2),
        ("7 words a row (4 pairs from odd j0)", crng.rule_stream(2, crng.SRC_OFF),
         gathered[:997], 5, 7),
        ("counters up to 2^32-1, last words", crng.rule_stream(1, crng.SRC_OFF),
         np.array([2**32 - 1, 0, 2**32 - 2, 2**32 - 1, 12345] * 13, np.int64),
         2**32 - 37, 37),
        ("zero rows", crng.STREAM_V, np.zeros(0, np.int64), 0, 7),
        ("zero words", crng.STREAM_V, np.arange(10, dtype=np.int64), 5, 0),
    ]


def phase_keystream_kernel(seed, card):
    """p1: the keystream kernel bit-exact against its plain version on the
    card and against numpy ``word_matrix``; empty calls launch nothing.
    Returns the largest |kernel - plain| over the words as integers."""
    err = 0
    for label, stream, rows, j0, n_words in keystream_cases(seed):
        rows_t = torch.from_numpy(rows).to(card)
        before = ks_mod.COUNTER.launches
        got = ks_mod.keystream_cuda(seed, stream, rows_t, j0, n_words)
        torch.cuda.synchronize()
        launched = ks_mod.COUNTER.launches - before
        require(launched == (1 if rows.size and n_words else 0),
                f"keystream {label}: {launched} launches")
        want = ks_mod.keystream_plain(seed, stream, rows_t, j0, n_words)
        require(got.shape == (rows.size, n_words) and torch.equal(got, want),
                f"keystream {label}: kernel differs from its plain version")
        if got.numel():
            err = max(err, int((got.long() - want.long()).abs().max()))
        oracle = crng.word_matrix(seed, stream, rows, j0, n_words)
        require(np.array_equal(ks_mod.as_uint32(got), oracle),
                f"keystream {label}: kernel differs from numpy word_matrix")
        say("p1", f"keystream {label}: {rows.size} x {n_words} (j0={j0}), {launched} launch, "
            "bit-exact vs plain (card) and numpy word_matrix")
        del got, want, oracle
    return float(err)


def require_same_build(a, b, what):
    """Every array of every partition, dist, meta and rule_spec equal."""
    require((a.n, a.m, a.k) == (b.n, b.m, b.k), f"{what}: shapes differ")
    require(np.array_equal(a.dist, b.dist), f"{what}: dist differs")
    for pa, pb in zip(a.parts, b.parts):
        for key in BUILD_ARRAYS:
            require(np.array_equal(getattr(pa, key), getattr(pb, key)),
                    f"{what}: partition {pa.part_id} {key} differs")
    require(a.meta == b.meta and a.rule_spec == b.rule_spec, f"{what}: meta or rule_spec")


def build_line(rep):
    return (f"{rep.seconds:.1f} s: keystream {rep.keystream_seconds:.2f} s ({rep.path}, "
            f"{rep.keystream_calls} calls, {rep.keystream_words} words, "
            f"{rep.d2h_bytes / 1e9:.3f} GB copied back), numpy assembly "
            f"{rep.assembly_seconds:.1f} s")


def phase_rules_brunel(seed, card):
    """p2: the Brunel rules net built on the card equals the numpy build;
    k=4 on one card equals k=1 in raster, traces and weights."""
    spec = balanced_ei_rules(n=PLASTIC_N, stdp=True, seed=seed)
    reset_counts()
    dev_net = build_network(spec, K_PARTS, uniform=True, path="device", device=card)
    launches = read_counts()
    rep = dev_net.build_report
    require(rep.keystream_calls > 0 and launches == only(keystream=rep.keystream_calls),
            f"device build launches {launches}, {rep.keystream_calls} keystream calls")
    ref_net = build_network(spec, K_PARTS, uniform=True, path="ref")
    require_same_build(dev_net, ref_net, "balanced_ei_rules device vs ref build")
    say("p2", f"balanced_ei_rules(n={PLASTIC_N}, stdp=True) k={K_PARTS} uniform: n={dev_net.n}, "
        f"m={dev_net.m}; every partition array, dist, meta and rule_spec equal between the "
        f"card build ({build_line(rep)}) and the numpy build ({build_line(ref_net.build_report)})")
    del dev_net, ref_net

    t0 = time.perf_counter()
    ses1 = Session(spec, SimConfig())
    ses4 = Session(spec, SimConfig(), k=K_PARTS, engine="spmd", devices=[card] * K_PARTS)
    torch.cuda.synchronize()
    say("p2", f"Session(spec) and Session(spec, k={K_PARTS}, engine='spmd'): "
        f"{time.perf_counter() - t0:.1f} s (two builds, ELL, upload); engines "
        f"{ses1.engine_choice.engine}, {ses4.engine_choice.engine}")
    require(ses1.engine_choice.engine == "fused_plastic", f"engine {ses1.engine_choice}")
    require(ses4.net.n == ses1.net.n == PLASTIC_N, "the k=4 rules net has padding")
    reset_counts()
    _, _, r1, s1 = run_session(ses1, PARITY_STEPS)
    l1 = read_counts()
    require(l1 == only(fused_plastic_step=PARITY_STEPS, noise_add=PARITY_STEPS),
            f"k=1 launches {l1}")
    reset_counts()
    _, _, r4, s4 = run_session(ses4, PARITY_STEPS)
    l4 = read_counts()
    nd = len(ses4.simulator.devs[0].cols)
    require(l4 == plastic_k4_launches("local", True, PARITY_STEPS, nd), f"k=4 launches {l4}")
    require(int(r1.raster.sum()) > 0, "the Brunel rules net never spiked")
    require(np.array_equal(r4.raster, r1.raster), "k=4 raster differs from k=1's")
    dv = require_plastic_equal(ses4, ses1, "Brunel rules net k=4")
    changed = check_learned(ses1.simulator, ses1.state["weights"])
    say("p2", f"{PARITY_STEPS} steps: k=1 fused_plastic {s1 / PARITY_STEPS * 1e6:.1f} us/step, "
        f"k={K_PARTS} fused_split_plastic {s4 / PARITY_STEPS * 1e6:.1f} us/step; raster "
        f"({int(r1.raster.sum())} spikes), hist, traces and weights ({changed} slots changed) "
        f"bit-identical, max |v difference| {dv:.3e}; launches {l1}, {l4}")


def phase_rules_microcircuit(args, card):
    """p3: the slice's main path, ``Session(microcircuit_rules(scale))`` with
    the keystream on the card, then 1000 steps, then rows of the card-built
    net against the numpy oracle's ``build_partition``."""
    spec = microcircuit_rules(scale=args.scale, seed=args.seed)
    reset_counts()
    t0 = time.perf_counter()
    ses = Session(spec, SimConfig())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts()
    rep, sim = ses.net.build_report, ses.simulator
    require(rep.path == "device" and rep.device == str(card), f"build on {rep.path} {rep.device}")
    require(rep.keystream_calls > 0 and rep.keystream_words > 0
            and launches == only(keystream=rep.keystream_calls),
            f"build launches {launches}, {rep.keystream_calls} keystream calls")
    shapes = [(b.delay, b.cols.shape) for b in sim.ell.buckets]
    say("p3", f"Session(microcircuit_rules(scale={args.scale})): n={ses.n}, m={ses.m}, "
        f"{len(spec.rules)} rules; {secs:.1f} s = build {build_line(rep)}; ELL and upload "
        f"{secs - rep.seconds:.1f} s; buckets {shapes}, fill {sim.ell.fill_factor:.3f}; engine "
        f"{ses.engine_choice}; host peak RSS "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.1f} GiB")
    pops = {p: spec.offsets()[p] for p in (q.name for q in spec.populations)}
    _, run_launches = phase_main_path(ses, ses.n, pops, tag="p3", need_event=False)

    part = ses.net.parts[0]
    bounds = np.concatenate([[0], np.cumsum(np.bincount(block_partition(spec.n, ROW_CHECK_K)))])
    t0 = time.perf_counter()
    for p in ROW_CHECK_PARTS:
        want = build_partition(spec, ROW_CHECK_K, p, path="ref")
        a, b = int(bounds[p]), int(bounds[p + 1])
        e0, e1 = int(part.row_ptr[a]), int(part.row_ptr[b])
        require(np.array_equal(np.diff(part.row_ptr[a:b + 1]), np.diff(want.row_ptr)),
                f"partition {p} of {ROW_CHECK_K}: row lengths differ")
        for key, got in (("col_idx", part.col_idx[e0:e1]), ("edge_model", part.edge_model[e0:e1]),
                         ("edge_state", part.edge_state[e0:e1]),
                         ("vtx_state", part.vtx_state[a:b]), ("coords", part.coords[a:b]),
                         ("global_ids", part.global_ids[a:b])):
            require(np.array_equal(got, getattr(want, key)),
                    f"partition {p} of {ROW_CHECK_K}: {key} differs from the numpy oracle's")
    say("p3", f"rows of partitions {ROW_CHECK_PARTS} of a k={ROW_CHECK_K} block partition "
        "(numpy oracle build_partition) equal the card-built net's in row lengths, col_idx, "
        f"edge_model, edge_state, vtx_state, coords and global_ids "
        f"({time.perf_counter() - t0:.1f} s)")
    return launches["keystream"], run_launches["fused_step"]


def phase_keystream_timing(seed, card, launches, err):
    """p4: the kernel at the largest build call with CUDA events, beside its
    plain version and its bound."""
    cases = keystream_cases(seed)
    _, stream, rows, j0, n_words = cases[1]
    rows_t = torch.from_numpy(rows).to(card)
    t_real = cuda_ms(lambda: ks_mod._launch(seed, stream, rows_t, j0, n_words), 20)
    b_real = keystream_bound(rows.size, j0, n_words)[0]
    say("p4", f"keystream {rows.size} x {n_words} (the build's largest call): kernel "
        f"{t_real:.4f} ms, bound {b_real:.4f} ms")
    _, stream, rows, j0, n_words = cases[0]
    rows_t = torch.from_numpy(rows).to(card)
    tk = cuda_ms(lambda: ks_mod._launch(seed, stream, rows_t, j0, n_words), 20)
    tp = cuda_ms(lambda: ks_mod.keystream_plain(seed, stream, rows_t, j0, n_words), 3)
    sass = keystream_sass()
    c = sass["per_cipher"]
    say("p4", f"keystream SASS (cuobjdump), the item loop of G = {sass['g']} ciphers: "
        f"{sass['body']} instructions, by pipe {sass['pipes']}; {sass['shf']} rotates as SHF.L.W "
        f"and {sass['wide']} as IMAD.WIDE.U32 ({sass['folded']} ORs folded into the "
        f"{sass['xors']} xors' LOP3), adds {sass['adds']}: a cipher is {c['alu']:.2f} ALU-pipe "
        f"and {c['fma']:.2f} FMA-pipe dispatch slots (IMAD.WIDE twice), {c['dispatch']:.2f} "
        "instructions")
    t_d2h = cuda_ms(lambda: ks_mod._launch(seed, stream, rows_t, j0, n_words).cpu(), 3)
    b, by, n_bytes, ciphers, times = keystream_bound(rows.size, j0, n_words)
    issue = sass_ms(ciphers)
    say("p4", f"keystream {rows.size} x {n_words}: kernel {tk:.4f} ms "
        f"({ciphers / tk / 1e6:.1f} G ciphers/s, {n_bytes / tk / 1e6:.0f} GB/s), plain {tp:.3f} ms, "
        f"bound {b:.4f} ms ({by}; bytes {times['bytes']:.4f} ms for {n_bytes / 1e9:.3f} GB, "
        f"{ciphers} ciphers' {CIPHER_INT_OPS} integer operations each {times['int32']:.4f} ms at "
        f"{DISPATCH_PER_S / 1e12:.2f} T lanes/s over both pipes); the built loop's issue time "
        f"(SASS counts, diagnostic): ALU pipe {issue['alu']:.4f}, FMA pipe {issue['fma']:.4f}, "
        f"dispatch {issue['dispatch']:.4f} ms; with the copy to the host {t_d2h:.3f} ms; "
        "library: none (torch's generators are Philox; no PyTorch call computes Threefry words)")
    src, rep = SOURCES["keystream"]
    return dict(name="keystream", route="cuda", source=src, replaces=rep, launches=launches,
                max_abs_err=err, ms=tk, plain_ms=tp, bound_ms=b, bound_by=by, library_ms=None,
                bound_parts_ms=times, sass_issue_ms=issue,
                path="procedural build of microcircuit_rules")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="network and input seed")
    ap.add_argument("--scale", type=float, default=1.0, help="microcircuit scale")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    name, count, smi = phase_device()
    phase_build()
    card = torch.device("cuda", torch.cuda.current_device())

    # one build of the microcircuit, as the uniform k>1 net; the k=1 paths
    # run its merge (the same labelling, with the inert padding neurons)
    t0 = time.perf_counter()
    mdef = microcircuit(scale=args.scale, seed=args.seed)
    d4 = to_dcsr(mdef, assignment=block_partition(mdef.n, K_PARTS), uniform=True)
    say("host", f"microcircuit(scale={args.scale}) -> to_dcsr, {K_PARTS} uniform blocks: "
        f"n={d4.n} ({d4.n - mdef.n} inert padding neurons), m={d4.m}, "
        f"{time.perf_counter() - t0:.1f} s")
    del mdef
    t0 = time.perf_counter()
    net = merge_to_single(d4)
    say("host", f"merge_to_single: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ses = Session(net, SimConfig())
    sim = ses.simulator
    torch.cuda.synchronize()
    shapes = [(b.delay, b.cols.shape) for b in sim.ell.buckets]
    panel_gb = sum(c.numel() * 8 for c in sim.dev.cols) / 1e9
    say("host", f"Session (ELL build, touch bitmaps, upload): {time.perf_counter() - t0:.1f} s; "
        f"buckets {shapes}; {panel_gb:.3f} GB of cols + weights and "
        f"{sim.event_plan.touch.numel() / 1e9:.3f} GB of touch bitmaps on the card; fill "
        f"{sim.ell.fill_factor:.3f}; engine {ses.engine_choice}; host peak RSS "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.1f} GiB")

    params = lif_params(net)
    inputs, errs = phase_kernels(sim, params, np.random.default_rng(args.seed))
    main_raster, launches = phase_main_path(ses, net.n, pd14_populations(args.scale))
    errs["event_post_exchange"], event_act = phase_event(sim, main_raster)
    unfused = phase_parity(net, main_raster, len(sim.dev.cols))
    # spike_gather and lif_step run only on the unfused path (the step front
    # took lif_step's place on fused_event): their counts are that run's
    launches["spike_gather"] = unfused["spike_gather"]
    launches["lif_step"] = unfused["lif_step"]
    phase_small_net()
    phase_nan(card, args.seed)
    kernels = phase_timing(ses, params, inputs, event_act, errs, launches)
    kernels.append(phase_noise_add(ses, args.seed, card, launches["noise_add"]))
    front_in = front_case(ses)
    check_front("main path", *front_in[:4], args.seed, front_in[4], sim.noise_sigma, params)
    kernels.append(front_timing("main path", *front_in[:4], args.seed, front_in[4],
                                sim.noise_sigma, params, launches["step_front"], "main"))
    k1_olds = {"dense": [("the old noise chain", old_chain_step(sim, "dense"))],
               "event": [("the old chain", front_engine_ab("front", sim, "event", ses.state)[0]),
                         ("the old noise chain", old_chain_step(sim, "event"))]}
    phase_engines(ses)
    del inputs, front_in
    gc.collect()
    torch.cuda.empty_cache()

    # the k=1 session stays for the profiler phases, which run after the
    # timed k>1 paths; the k>1 path's memory is counted above what it holds
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ses4 = spmd_session(d4, card)
    dsim = ses4.simulator
    torch.cuda.synchronize()
    sub = {key: [tuple(a.shape) for a in getattr(dsim.devs[0], key)]
           for key in ("cols", "cols_local", "cols_remote")}
    gb = sum(a.numel() * 8 for dev in dsim.devs
             for a in dev.cols + dev.cols_local + dev.cols_remote) / 1e9
    say("host", f"Session(engine='spmd', devices=[card] * {K_PARTS}) (stack_partitions, "
        f"split_overlap_panels, touch bitmaps, upload): {time.perf_counter() - t0:.1f} s; "
        f"partition 0 panels {sub}; {gb:.3f} GB of cols + weights (whole and local/remote "
        f"sub-panels) on the card; engine {ses4.engine_choice}; host peak RSS "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.1f} GiB")
    k4_act = main_raster[STEPS // 2]
    k4_errs = phase_k4_kernels(dsim, k4_act)
    k4_raster, k4_launches, _ = phase_k4_main(ses4, main_raster, base)
    phase_k4_variants(ses4, card, k4_raster, len(dsim.devs[0].cols))
    kernels += phase_k4_timing(dsim, k4_act, k4_errs, k4_launches)
    phase_k4_engines(ses4)
    phase_k4_front_host(ses4, params)
    k4_olds = {g: [("the old chain", front_engine_ab("front", dsim, g, ses4.state)[0])]
               for g in ("dense", "event")}
    # torch.profiler only now, after every timed k=1 and k>1 microcircuit run
    phase_step_kernels("front", sim, ses.state, k1_olds)
    phase_step_kernels("front", dsim, ses4.state, k4_olds)
    del ses4, dsim, d4, k1_olds, k4_olds
    gc.collect()
    torch.cuda.empty_cache()
    # save -> restore -> continue, after every timed run of the main path
    phase_snapshot_microcircuit(ses, smi)
    del ses, sim, net  # the plastic paths' memory alone
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    pd4 = to_dcsr(balanced_ei(n=PLASTIC_N, stdp=True, seed=args.seed),
                  assignment=block_partition(PLASTIC_N, K_PARTS), uniform=True)
    pnet = merge_to_single(pd4)
    say("host", f"balanced_ei(n={PLASTIC_N}, stdp=True) -> to_dcsr, {K_PARTS} uniform blocks, "
        f"and its merge: n={pnet.n}, m={pnet.m}, {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pses = Session(pnet, SimConfig())
    psim = pses.simulator
    torch.cuda.synchronize()
    n_plastic = sum(int(p.sum()) for p in psim.dev.plastic)
    panel_gb = sum(c.numel() * 12 for c in psim.dev.cols) / 1e9
    say("host", f"Session (ELL build, plastic masks, upload): {time.perf_counter() - t0:.1f} s; "
        f"{len(psim.dev.cols)} buckets of {tuple(psim.dev.cols[0].shape)}, fill "
        f"{psim.ell.fill_factor:.3f}, {n_plastic} plastic slots; {panel_gb:.3f} GB of cols, "
        f"weights and masks on the card; engine {pses.engine_choice}; STDP {psim.stdp_params}")
    pparams = lif_params(pnet)
    p_inputs, p_errs = phase_plastic_kernels(psim, pparams, np.random.default_rng(args.seed))
    p_raster, p_launches = phase_plastic_path(pses, pnet.n)
    unf, fus, unf_launches = phase_plastic_parity(pnet, p_raster)
    # stdp_update runs only on the unfused plastic path: its count is that run's
    p_launches["stdp_update"] = unf_launches["stdp_update"]
    phase_plastic_engines(pses, unf)
    phase_plastic_small_net(args.seed)
    kernels += phase_plastic_timing(psim, pparams, p_inputs, p_errs, p_launches)

    t0 = time.perf_counter()
    pses4 = spmd_session(pd4, card)
    pdsim = pses4.simulator
    say("host", f"Session(engine='spmd', devices=[card] * {K_PARTS}) of the plastic net: "
        f"{time.perf_counter() - t0:.1f} s; {len(pdsim.devs[0].cols)} buckets of "
        f"{tuple(pdsim.devs[0].cols[0].shape)} a partition; engine {pses4.engine_choice}")
    k4p_inputs, k4p_errs = phase_k4_plastic_kernels(pdsim, pparams,
                                                    np.random.default_rng(args.seed))
    k4p_launches = phase_k4_plastic_path(pses4, pses, p_raster)
    k4p_var = phase_k4_plastic_variants(pses4, card, fus, p_raster, len(pdsim.devs[0].cols))
    taus = stdp_taus(pdsim)
    vtx0, slot0, ids0, hist0, t0_p = front_case(pses4, 0)
    traces0 = (pses4.state[0]["tr_plus"], pses4.state[0]["tr_minus"])
    check_front("k>1 Brunel partition 0", vtx0, slot0, ids0, hist0, args.seed, t0_p,
                pdsim.noise_sigma, pparams, traces0, taus)
    p_old, p_old_launches = front_engine_ab("front", pdsim, "dense", pses4.state)
    # no engine runs pre_exchange since the step front took its place: its
    # count is the old chain's run's (front_engine_ab)
    kernels += phase_k4_plastic_timing(pdsim, pparams, k4p_inputs, k4p_errs, dict(
        pre_exchange=p_old_launches["pre_exchange"],
        post_exchange_remote_plastic=k4p_launches["post_exchange_plastic"],
        post_exchange_plastic=k4p_var["overlap off"]["post_exchange_plastic"]))
    kernels.append(front_timing("k>1 Brunel partition 0", vtx0, slot0, ids0, hist0, args.seed,
                                t0_p, pdsim.noise_sigma, pparams, k4p_launches["step_front"],
                                "k4_plastic", traces0, taus))
    phase_step_kernels("front", pdsim, pses4.state, {"dense": [("the old chain", p_old)]})
    phase_snapshot_brunel(pses4, card, smi)
    del pses4, pdsim, pses, psim, pnet, pd4, unf, fus, k4p_inputs, p_inputs
    gc.collect()
    torch.cuda.empty_cache()

    # procedural construction: RuleSpec -> build_network (keystream on the
    # card) -> Session
    ks_err = phase_keystream_kernel(args.seed, card)
    phase_rules_brunel(args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    ks_launches, rules_fused = phase_rules_microcircuit(args, card)
    gc.collect()
    torch.cuda.empty_cache()
    kernels.append(phase_keystream_timing(args.seed, card, ks_launches, ks_err))
    next(k for k in kernels if k["name"] == "fused_step")["launches_rules_microcircuit"] = \
        rules_fused
    say("done", f"every phase passed; whole script {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        shutil.rmtree(SNAP_ROOT, ignore_errors=True)
