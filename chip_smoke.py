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
  [contracts] the card view of the engine-contract matrix
     (``python -m repro_torch.analysis.contracts --device cuda``): every
     row's uncaptured ops (exchanges, host syncs, 8-byte values), its
     captured graph's kernel nodes a step and no memcpy to the host, and
     an uncaptured chunk under ``set_sync_debug_mode("error")``;
  [lm] the LM substrate's serving path at full width (``repro_torch.models``,
     ``repro_torch.train.serve``): smollm-135m, granite-moe-3b-a800m,
     recurrentgemma-2b, xlstm-350m, paligemma-3b (256 stub image tokens) and
     whisper-small (16 stub frames), each with its own param and compute
     dtypes and weights drawn on the card from ``--seed``: ``greedy_generate``
     at batch 4, prompt 16, 24 new tokens; the prefill and the decode steps
     timed, peak device memory; one decode step under
     ``set_sync_debug_mode("error")`` with its aten ops counted; the last
     decode step against a cache-free forward over the whole sequence (the
     VLM at ``S + n_img``, ROADMAP F10; an MoE at a capacity where nothing
     drops); at 2 periods and fp32 compute, the card against the CPU and the
     card's cache path against its forward; then smollm-135m at batch 64,
     prompt 512, 128 new tokens (the LM adds no kernel);
  [train] the LM substrate's training slice (``repro_torch.train``,
     ``repro_torch.io.CheckpointManager``; no kernel of its own):
     smollm-135m at full width and depth (fp32 params, bf16 compute, batch
     8, seq 128, the affine task, AdamW with fp32 moments under the
     launcher's cosine schedule): 8 steps straight, an async checkpoint of
     the reference launcher's tree at step 4 (fsync on, under ``_snap/``),
     then a fresh model restored from step 4 through ``fit`` to step 8,
     whose parameters match the straight run's; every loss finite, the
     last 5 under the first; one step under ``set_sync_debug_mode("error")``;
     ms a step, tokens/s, peak device memory, the checkpoint's bytes, save
     stall, write and restore seconds; then granite-moe-3b-a800m at full
     width and depth with 8-bit moments, 3 steps at batch 4, seq 128 (the
     MoE aux losses in the metrics, every parameter moved, the drop
     fraction); then both configs at full width, 2 periods deep, fp32
     compute, on the card against the CPU: the loss, every gradient and
     the optimizer's update given the same gradients;
  [mesh] the LM substrate's mesh half (``repro_torch.sharding``; no kernel
     of its own), in a child process (``--mesh-child``) with a world-size-1
     NCCL process group and a 1x1 ``("data", "model")`` mesh on the card:
     smollm-135m at full width in fp32 compute, batch 8 x 128, 2 AdamW steps
     with the policy (parameters as DTensors) against 2 without, losses and
     parameters within the stated tolerances, ms a step each way
     (DTensor's host cost); granite-moe-3b-a800m with
     ``moe_impl="ep_shard_map"`` under the policy against ``gspmd`` without
     one, a prefill and 8 greedy decode steps, equal tokens; then the two
     dry-run cells started after the build in background processes (smollm-135m
     ``train_4k``, granite-moe-3b-a800m ``decode_32k`` with EP, a fake 16x16
     process group, meta shards: seconds and bytes per device);
  [lm child] two child processes on the card (``--lm-child serve`` and
     ``--lm-child train``), each beside a host build of the parent's in
     which the card idles, joined before the parent's next allocation or
     timed run there, their lines printed at the join: right after [mesh],
     beside the microcircuit's ``to_dcsr`` and merge, stablelm-12b,
     phi3-medium-14b and command-r-35b (bf16 params, 56.4 GiB for
     command-r) through every ``[lm]`` check at batch 4, prompt 16, 24 new
     tokens, with the card's free memory before each build and the cache
     path against the cache-free forward also at full depth in fp32
     compute; beside p3's build, recurrentgemma-2b, xlstm-350m,
     paligemma-3b and whisper-small trained at full width and depth, batch
     4 x 128 (stub image tokens and frames), AdamW fp32 moments, 3 steps (2
     where a step takes over 3 s), the second under
     ``set_sync_debug_mode("error")``, every loss finite, every parameter
     moved (a bf16 one of magnitude >= 0.5 may round its update away, as in
     the reference, if its first moment moved), and each against the CPU
     at 2 periods in fp32;
  3. kernels vs plain at the main path's shapes (the session's own panels,
     inputs from ``--seed``): ``lif_step`` bit-exact, ``spike_gather``
     (with the panels' row lengths) within rtol=atol=1e-5, equal to itself
     over whole rows and with the bitmask in device memory, and, through
     the reference's ring formulation, bit-equal to ``post_exchange``'s
     forced ``row_dot`` variant; ``fused_step`` (row lengths, the session's
     recorded ``reduce``) bit-exact against its forced ``row_dot`` variant,
     its L2 bitmask and ``lif_step`` then ``spike_gather``, and within 1e-5
     of its plain version; both again on the session's panels cast to
     bf16, bit-equal to the same kernels on the panels' f32 widening;
  4. main path: 1000 steps; the launch counts, set to 0 just before the run
     and read just after, must match the gather mode of every chunk (a
     ``fused`` step launches ``noise_add`` and ``fused_step``, a
     ``fused_event`` step ``step_front`` and the event kernel);
  5. the event kernel against its plain version, its forced ``row_dot``
     variant and the dense kernels, on spike vectors of the main path's
     raster, and on the panels cast to bf16 bit-equal to their f32
     widening;
  6. the unfused path: 256 steps on the ``unfused`` engine, counts set to
     0 before and read after, whose raster must equal the main path's
     first 256 steps (on the main session's panels, ``_share``); then
     ``[maxk]``: ``Session(net, SimConfig(max_k=512))`` on the same net
     (and, after the plastic parity, ``SimConfig(max_k=64, align_k=32)``
     on the Brunel net): the split step's one ``segment_gather`` launch
     (every bucket's gather, segment sums and ring add) bit-equal to the
     old composition (the unsegmented ``spike_gather`` kernel's virtual
     rows, ``ref.segment_add_ref``, ``index_add_`` a bucket) and within
     1e-5 of its plain version on a main-path and a 5% vector, each
     bucket's ring row within 1e-5 of ``torch.sparse.mm`` over its real
     rows, timed in turns with that composition and beside the library
     (on the Brunel
     net also ``stdp_update_step``'s one launch over every bucket, the
     split ones with ``row_map``'s post terms, bit-equal to its plain
     version and to the per-panel kernel a bucket, timed in turns with that
     loop and beside its bound); 256 steps graphed, uncaptured and
     replayed, rasters and end states bit-equal, one ``segment_gather``
     launch a step (and one ``stdp_update``); then a
     small network on the card against the plain
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
     main path, with the bitmask read from device memory too, and with
     bf16 weights (2 B an active weight in the bound);
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
      version; each on bf16 panels bit-equal to their f32 widening;
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
     panels: ``stdp_update`` bit-exact for every bucket, and on the panels
     cast to bf16 (a bf16 and an f32 mask; every op rounded to bf16, the
     reference kernel's rule) in place and out of place, ``fused_step_plastic``
     bit-exact against ``lif_step`` + trace decay + ``spike_gather`` +
     ``stdp_update`` and against its plain version but for the currents
     (rtol=atol=1e-5); and as the engine launches it (the real slots by
     ``row_len``, the currents added into the ring in the launch, the
     weights in place): the ring bit-exact against ``index_add_`` of its
     currents, the rest against the every-slot launch, no padding or
     non-plastic slot written;
  9. 1000 steps with both monitors, every chunk on ``fused_plastic``, counts
     set to 0 just before and read just after; plastic slots changed,
     non-plastic and padding slots bit-identical to the initial weights,
     plastic weights within ``[w_min, w_max]``;
 10. 256 steps of ``SimConfig(fused=False)`` (``lif_step``, then per bucket
     ``spike_gather``, then one ``stdp_update`` launch over every bucket),
     counts checked, whose raster,
     traces and weights equal a fresh ``fused_plastic`` run's bit for bit;
 11. both plastic engines' us/step; a small plastic net on the card against
     the CPU plain versions; timing of both plastic kernels (``stdp_update``
     as the engine's one ``stdp_update_step`` launch a step, in place,
     first held bit for bit against its plain version and the per-panel
     kernel a bucket, then timed in turns with that old loop; and per
     panel on the bf16 panels, with
     either mask), their plain versions and
     their bounds (the real slots by ``row_len``; ``stdp_update_step``'s
     those of the rows its plan lists; every slot in brackets);
     the ``[graph]`` line holds the graphed step to 16 kernels.

The k>1 plastic path: the k=4 net on the one card with ``SimConfig()``
(dense exchange of spikes and pre-traces, overlap ``local``,
``fused_split_plastic``: the step front with both trace decays, the local
``post_exchange`` pass, the remote ``post_exchange_plastic`` pass):
 12. ``pre_exchange`` and both variants of ``post_exchange_plastic`` on
     partition 0 against their plain versions and the unfused kernels, and
     in the engine's form (``row_len``, the weights in place, the remote
     pass's own slice zeroed in the kernel) against the every-slot launch;
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
     t, ``Session.restore(path)`` onto the card in a fresh process (f1),
     then 200 steps of the live and of the restored session: rasters, spike
     counts, ``vtx_state``, ``ring``, ``hist`` and traces bit-equal (by
     digest);
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

Fault tolerance, on the s1 snapshot before it is removed and on the p2
session:
 f1. ``[ingest]``: ``Session.restore(path)`` (s1's restore) and
     ``Session.restore(path, streaming=True)`` onto the card, each in a fresh
     process of this script (``--restore-child``, started through a small
     launcher process made at the script's start, so that its
     ``ru_maxrss`` is its own): load and build seconds, the child's peak RSS
     after the load and after the build, its carry bit-equal (by digest) to
     the live session's at the save, and 200 steps whose raster, spike
     counts and end carry equal the live session's;
 f2. ``[super] main``: the main path's session rewound to the snapshot's
     step (the snapshot is the checkpoint root's first step), an undisturbed
     ``run(256, chunk_size=64)``, then ``run_supervised(256, chunk_size=64,
     checkpoint_every=128, max_to_keep=2)`` from the same state under the
     port's ``FaultPlan([Fault("supervisor:state", "nan", after=2,
     count=1)], seed=FAULT_SEED)``, a NaN in one seeded membrane after the
     third chunk: the plan fired once, one rollback, 64 steps lost, raster, spike counts, ``vtx_state``, ring and
     hist bit-equal to the undisturbed run, the same simulator, no graph key
     added or captured again; the rollback's seconds (writer drain,
     ``restore_resilient``, in-place reload), us/step against the plain run
     and the checkpoint stalls;
 f3. ``[super] k4p chaos``: the p2 k=4 session (its manifest carries the
     RuleSpec), ``run_supervised(512, chunk_size=128,
     checkpoint_every=128)`` under one of the port's ``FaultPlan`` s:
     ``Fault("shard_write", "io_error", per_path=True)`` (a transient
     ``OSError`` on each shard's first write), a ``supervisor:state``
     ``nan`` after chunk 2 (partition and row drawn from the seed) and a
     ``shard_read`` ``bit_flip`` matching the newest step's ``part0.npz``,
     which fires at the rollback's first read of it; ``plan.fired`` checked
     by kind: one rollback to t0 (256 steps lost) through the quarantine
     and the regeneration of partition 0 from the keystream on the card;
     the whole carry bit-equal to an undisturbed run and ``net.parts[0]``
     equal to a fresh ``build_partition``; the regeneration's seconds and
     keystream launches;
 f4. ``[chaos]``: on the same k=4 session, from one start state,
     ``run(256, checkpoint_every=64, max_to_keep=2)`` clean and then under
     each of the port's ``chaos_plan(name, seed=0)`` (transient-io,
     torn-write, slow-disk) into a fresh root, the writes drained inside
     the plan: the plan fired, the end carry bit-equal to the clean run's
     and every file of both kept steps equal to the clean run's by
     ``file_crc``; us/step, the writer's drain and the checkpoint stalls
     beside the clean run's.  Then ``run_supervised(256, chunk_size=64,
     checkpoint_every=64)`` under ``Fault("supervisor:state", "storm",
     after=1, count=1)``: one rollback of 64 steps, caught on chunk 2 by
     the membrane ceiling ``HealthConfig().max_vm`` reduced on the card,
     in place, the end carry bit-equal to the clean run's.

The compiled chunk (``[graph]`` lines; on the card every run replays one
CUDA graph per step engine, chunk length and recordings): after each path
(main, k4, plastic, k4p, p2 at k=1 and k=4, p3, and the checkpointed Brunel
run) the session is rewound to the path's start state and run the path's
steps graphed and uncaptured (the ``_graphs=False`` seam), once each, each
raster equal to the path's and the end states bit-equal, with the us/step
of both; each captured key's warm-up, capture and instantiation seconds and
its graph's nodes by kind (``cuGraphGetNodes`` on ``raw_cuda_graph()``),
kernels a step; one uncaptured chunk under
``torch.cuda.set_sync_debug_mode("error")``; and, after the net's timed runs
and profiler phases, the card's idle share over one graphed and one
uncaptured chunk (the union of ``torch.profiler``'s device intervals over a
window of CUDA events).  The kernels of ``noise``, ``step_front`` and
``event_step`` are timed as the engines launch them, with ``t`` on the card.

It ends with a JSON line of kernel figures, the nvidia-smi line, and
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a card it exits 1 before printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import hashlib
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
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import event_step as event_mod  # noqa: E402
from repro_torch.kernels import fused_step as fused_mod  # noqa: E402
from repro_torch.kernels import lif_step as lif_mod  # noqa: E402
from repro_torch.kernels import noise as noise_mod  # noqa: E402
from repro_torch.kernels import segment_gather as seg_mod  # noqa: E402
from repro_torch.kernels import spike_gather as gather_mod  # noqa: E402
from repro_torch.kernels import split_step as split_mod  # noqa: E402
from repro_torch.kernels import step_front as front_mod  # noqa: E402
from repro_torch.kernels import stdp_update as stdp_mod  # noqa: E402
from repro_torch.kernels import keystream as ks_mod  # noqa: E402
from repro_torch.analysis.contracts import (  # noqa: E402
    graph_node_kinds, run_matrix, uncaptured,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, lm_param_leaves  # noqa: E402
from repro_torch.train import greedy_generate, make_prefill_fn, make_serve_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.train import (  # noqa: E402
    AdamW, DataConfig, batch_iterator, cosine_schedule, fit, host_batch, make_loss_fn,
    make_train_step,
)
from repro_torch.train.optimizer import flat_params  # noqa: E402
from repro_torch.builder import (  # noqa: E402
    balanced_ei_rules, build_network, build_partition, crng, microcircuit_rules,
)
from repro_torch.core import EDGE_DELAY, block_partition, merge_to_single  # noqa: E402
from repro_torch.io import (  # noqa: E402
    CheckpointManager, fsync_enabled, load_binary, snapshot_steps,
)
from repro_torch.snn import (  # noqa: E402
    HealthConfig, RasterMonitor, RateMonitor, Session, SimConfig, balanced_ei, microcircuit,
    to_dcsr,
)
from repro_torch.testing import (  # noqa: E402
    CHAOS_PLANS, Fault, FaultPlan, chaos_plan, file_crc, no_faults,
)
from repro_torch.snn.neurons import LIF_BIAS, LIF_PARAM_KEYS, LIF_REF, LIF_V  # noqa: E402
from repro_torch.kernels.dispatch import launch_row_dot, panel_reduce  # noqa: E402
from repro_torch.snn.session import _DEFAULT_CHUNK  # noqa: E402
from repro_torch.snn.simulator import (  # noqa: E402
    FRONT_ENGINES, TOPOLOGY_FIELDS, slot_tables, state_reduce,
)

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
            front_mod.COUNTER, seg_mod.COUNTER)
SOURCES = {
    "lif_step": ("src/repro_torch/kernels/csrc/lif_step.cu",
                 "src/repro/kernels/lif_step.py:38"),
    "spike_gather": ("src/repro_torch/kernels/csrc/spike_gather.cu",
                     "src/repro/kernels/spike_gather.py:65"),
    # spike_gather_pallas over a split bucket's virtual rows, with the
    # segment_sum and the ring add around it (simulator.py:644-655)
    "segment_gather": ("src/repro_torch/kernels/csrc/segment_gather.cu",
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


T_START = time.perf_counter()  # reset by main(); every line carries the seconds since


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] (at {time.perf_counter() - T_START:.1f} s) {msg}", flush=True)


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

    # bf16 weights: the session's panels cast to bf16, against the same
    # kernels on their f32 widening bit for bit (the widening is exact and
    # the sums run in the same order), and against the plain versions
    # (which widen with .float()) within the f32 tolerance
    w16 = [w.to(torch.bfloat16) for w in weights]
    red16 = panel_reduce(w16)
    errs["spike_gather_bf16"] = errs["fused_step_bf16"] = 0.0
    for c, w, rl, rb in zip(cols, w16, row_len, red16):
        wide = w.float()
        got = gather_mod.spike_gather_cuda(act, c, w, rl, reduce=(rb,))
        require(got.dtype == torch.float32 and torch.equal(
            got.view(torch.int32),
            gather_mod.spike_gather_cuda(act, c, wide, rl, reduce=(rb,)).view(torch.int32)),
            "bf16 spike_gather differs from the kernel on its f32 widening")
        require(torch.equal(gather_mod.spike_gather_cuda(act, c, w, reduce="row_dot"),
                            gather_mod.spike_gather_cuda(act, c, wide, reduce="row_dot")),
                "bf16 spike_gather's row_dot variant differs from its f32 widening's")
        want = ref.spike_gather_ref(act, c, w)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        errs["spike_gather_bf16"] = max(errs["spike_gather_bf16"], float((got - want).abs().max()))
        del wide
    f16 = fused_mod.fused_step_cuda(v, refrac, i_tot, cols, w16, row_len, params=params,
                                    reduce=red16)
    f32w = fused_mod.fused_step_cuda(v, refrac, i_tot, cols, [w.float() for w in w16], row_len,
                                     params=params, reduce=red16)
    require(all(torch.equal(a, b) for a, b in zip(f16[:3], f32w[:3])),
            "bf16 fused_step's LIF phase differs")
    require(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(f16[3], f32w[3])),
            "bf16 fused_step differs from the kernel on its f32 widening")
    del f32w
    _, _, s_p, curs_p = ref.fused_step_ref(v, refrac, i_tot, cols, w16, params=params)
    require(torch.equal(f16[2], s_p), "bf16 fused_step spikes differ from the plain version")
    for a, b in zip(f16[3], curs_p):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        errs["fused_step_bf16"] = max(errs["fused_step_bf16"], float((a - b).abs().max()))
    say("kernels", f"bf16 weights (the session's panels cast, reduce {red16}): spike_gather and "
        "fused_step bit-exact vs the same kernels on the panels' f32 widening (and spike_gather's "
        "row_dot variant); max |kernel - plain| = "
        f"{errs['spike_gather_bf16']:.3e} and {errs['fused_step_bf16']:.3e} (rtol=atol=1e-5)")
    return (v, refrac, i_tot, act, w16), errs


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
    t, vtx = int(st["t"]), st["vtx_state"]
    noise = ops.step_noise(sim.cfg.seed, t, sim.net.n, sim.noise_sigma, device=sim.device)
    ids = torch.from_numpy(ses.permanent_ids).to(sim.device)
    i_tot = (st["ring"][t % sim.d_ring] + noise.index_select(0, ids)) + vtx[:, LIF_BIAS]
    return vtx[:, LIF_V].contiguous(), vtx[:, LIF_REF].contiguous(), i_tot


def phase_event(sim, raster, w16):
    """The event kernel against its plain version and the dense kernels, on
    spike vectors of the main path (and one whose ids overflow the buffer);
    on the session's panels cast to bf16 (``w16``) bit-equal to the same
    kernel on their f32 widening."""
    plan, cols, weights = sim.event_plan, sim.dev.cols, sim.dev.weights0
    red16, wide = panel_reduce(w16), [w.float() for w in w16]
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
        for rb in (red16, "row_dot"):
            g16, g32 = ring.clone(), ring.clone()
            f16 = event_mod.event_post_exchange_cuda(act, g16, slot, write, plan, cols, w16,
                                                     row_len, reduce=rb)
            f32 = event_mod.event_post_exchange_cuda(act, g32, slot, write, plan, cols, wide,
                                                     row_len, reduce=rb)
            require(torch.equal(f16, f32) and torch.equal(g16.view(torch.int32),
                                                          g32.view(torch.int32)),
                    f"bf16 event kernel ({rb}) differs from its f32 widening ({what})")
        err = max(err, float((got - want).abs().max()))
        frac = float(flags.float().mean())
        flagged.append(frac)
        say("event", f"{what}: {int(a.sum())} spikes, {frac:.4f} of {flags.numel()} "
            f"(bucket, block) pairs flagged (blocks of {plan.block_r} rows); flags equal "
            "plain, ring bit-equal to spike_gather's, to its row_dot variant's and to "
            "post_exchange's row_dot variant; bf16 panels bit-equal to their f32 widening "
            "(recorded reduce and row_dot); max |kernel - plain| = "
            f"{float((got - want).abs().max()):.3e} (rtol=atol=1e-5)")
    return err, acts[f"main-path step {STEPS // 2}"]


def phase_parity(net, main_raster, nd, main_ses):
    """256 steps of the unfused engine on the main session's own panels
    (``_share``: no second ELL build), raster-equal to the main path."""
    ses = Session(net, SimConfig(fused=False), _share=main_ses)
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


# [maxk] figures for the kernels line, by session
MAXK = {}


def old_split_step(act, ring, t, dev, reduce):
    """The composition the split step's launch replaced: per bucket the
    unsegmented ``spike_gather`` kernel over the virtual rows, their
    ascending sum (``ref.segment_add_ref``; an unsplit bucket's first n_p
    rows as they are) and one ``index_add_`` into the bucket's ring row."""
    D, n_p = ring.shape
    for b, (c, w, rl, d) in enumerate(zip(dev.cols, dev.weights0, dev.row_len, dev.delays)):
        vrows = gather_mod.spike_gather_cuda(act, c, w, rl, reduce=reduce[b:b + 1])
        rp = dev.row_ptr[b]
        cur = vrows[:n_p] if rp is None else ref.segment_add_ref(vrows, rp, dev.segment.depth[b])
        ring.index_add_(0, torch.remainder(t + d, D).view(1), cur[None])
    return ring


def phase_maxk(tag, net, cfg, act_main, unsplit_raster, steps=PARITY_STEPS):
    """[maxk] ``Session(net, cfg)`` with ``cfg.max_k`` at full width: the
    unfused engine with split buckets, whose gathers, segment sums and ring
    adds are one ``segment_gather`` launch a step.  The launch's ring
    against the old composition (``old_split_step``) bit for bit, in the
    recorded reduction and the row_dot variant, and against the plain
    version within 1e-5, each bucket's ring row within 1e-5 of its start
    plus ``torch.sparse.mm`` over the bucket's real rows, on a main-path
    spike vector and a 5% vector, both timed in turns with the old
    composition and beside the library;
    then ``steps`` steps graphed and uncaptured, rasters and end states
    bit-equal, one launch a step of ``lif_step``, ``segment_gather`` and
    ``noise_add`` (and of ``stdp_update`` on a plastic net)."""
    t0 = time.perf_counter()
    ses = Session(net, cfg)
    sim = ses.simulator
    dev = sim.dev
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    plastic = dev.any_plastic
    require(ses.engine_choice.engine == "unfused", f"{tag}: engine {ses.engine_choice}")
    split = [i for i, ident in enumerate(dev.identity_rows) if not ident]
    require(split and dev.segment is not None, f"{tag}: max_k={cfg.max_k} split no row")
    n_p, nd, plan = dev.n_p, len(dev.cols), dev.segment
    panel_gb = sum(c.numel() * (12 if plastic else 8) for c in dev.cols) / 1e9
    say("maxk", f"{tag}: Session(SimConfig(max_k={cfg.max_k}, align_k={cfg.align_k})) on the "
        f"same net: {build_s:.1f} s (ELL build, tiles, upload); engine "
        f"{ses.engine_choice.engine} ({ses.engine_choice.reason}); buckets "
        + ", ".join(f"d={d} {tuple(c.shape)}" + (f" split: {plan.rows[i]} virtual rows, depth "
                                                 f"{plan.depth[i]}" if i in split else "")
                    for i, (d, c) in enumerate(zip(dev.delays, dev.cols)))
        + f"; {panel_gb:.3f} GB of cols + weights{' + masks' if plastic else ''}; fill "
        f"{sim.ell.fill_factor:.3f}; {plan.tiles.shape[0]} tiles of at most {plan.tile_slots} "
        "slots")
    csrs = [_csr_of(c, w, rl, n_p) if rp is None else _csr_rows(c, w, rl, rp, n_p)
            for c, w, rl, rp in zip(dev.cols, dev.weights0, dev.row_len, dev.row_ptr)]
    gen = torch.Generator(sim.device).manual_seed(2)
    vecs = {"main-path step": torch.from_numpy(act_main.astype(np.float32)).to(sim.device),
            "5% active": (torch.rand(n_p, generator=gen, device=sim.device) < 0.05).float()}
    ring0 = torch.randn((sim.d_ring, n_p), generator=gen, device=sim.device)
    t = torch.tensor(7 * sim.d_ring + 3, dtype=torch.int64, device=sim.device)
    red = dev.reduce
    fig, err = {}, 0.0
    for label, a in vecs.items():
        config = {}

        def launch(ring, reduce=red):
            return seg_mod.segment_gather_ring_cuda(
                a, ring, t, dev.delays, plan, dev.cols, dev.weights0, dev.row_len, dev.row_ptr,
                reduce=reduce, config=config)

        got = launch(ring0.clone())
        want = old_split_step(a, ring0.clone(), t, dev, red)
        require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                f"{tag}: the split step's launch differs from the old composition ({label})")
        require(torch.equal(launch(ring0.clone(), "row_dot"), got),
                f"{tag}: the launch differs from its row_dot variant ({label})")
        plain = ref.segment_gather_ring_ref(a, ring0.clone(), t, dev.delays, dev.cols,
                                            dev.weights0, dev.row_ptr, plan.depth)
        torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
        err = max(err, float((got - plain).abs().max()))
        a2 = a[:, None].contiguous()
        # each bucket's ring row against its start plus the library's sums
        t_host = int(t)
        for m, d in zip(csrs, dev.delays):
            slot = (t_host + d) % sim.d_ring
            torch.testing.assert_close(got[slot], ring0[slot] + torch.sparse.mm(m, a2)[:n_p, 0],
                                       rtol=1e-5, atol=1e-5)
        # the kernel, the old composition and the unsegmented kernel alone in
        # turns (kernel, old, old, kernel), each on its own ring
        rings = [ring0.clone() for _ in range(3)]
        times = {k: [] for k in ("ms", "old_ms", "vrows_ms")}
        for order in (("ms", "old_ms", "vrows_ms"), ("vrows_ms", "old_ms", "ms")):
            for k in order:
                if k == "ms":
                    times[k].append(cuda_ms(lambda: launch(rings[0]), 20))
                elif k == "old_ms":
                    times[k].append(cuda_ms(lambda: old_split_step(a, rings[1], t, dev, red), 10))
                else:
                    times[k].append(cuda_ms(lambda: [gather_mod.spike_gather_cuda(
                        a, c, w, rl, reduce=red[b:b + 1]) for b, (c, w, rl) in enumerate(
                        zip(dev.cols, dev.weights0, dev.row_len))], 20))
        f = {k: min(v) for k, v in times.items()}
        f["plain_ms"] = cuda_ms(lambda: ref.segment_gather_ring_ref(
            a, rings[2], t, dev.delays, dev.cols, dev.weights0, dev.row_ptr, plan.depth), 3)
        f["library_ms"] = cuda_ms(lambda: [torch.sparse.mm(m, a2) for m in csrs], 20)
        # the activity read once, then per bucket: each real slot's col,
        # the weight of each real slot whose source is active (of every real
        # slot on a row_dot bucket: the padding slots past row_len carry
        # nothing), row_len of each virtual row, row_ptr, and the ring row
        # read and written
        nb, active = 4 * a.shape[0], 0
        for i, (c, w, rl, rp) in enumerate(zip(dev.cols, dev.weights0, dev.row_len,
                                               dev.row_ptr)):
            v_rows = plan.rows[i]
            rows = torch.arange(c.shape[0], device=c.device) < v_rows
            real_, active_, _ = gather_traffic(a, c, rl, rows)
            if red[i] == "row_dot":
                active_ = real_
            active += active_
            nb += (4 * real_ + w.element_size() * active_ + 4 * v_rows
                   + (0 if rp is None else 4 * (n_p + 1)) + 8 * n_p)
        f["bound_ms"], f["bound_by"] = bound_ms(nb, 2 * active)
        f["gb"] = nb / 1e9
        f["config"] = dict(config)
        fig[label] = f
        say("maxk", f"{tag}: segment_gather over the {nd} bucket(s) ({len(split)} split), "
            f"{label} ({int(a.sum())} of {n_p} ids): ring bit-equal to the old composition "
            f"(unsegmented spike_gather, segment_add_ref, index_add_ a bucket) and to its "
            f"row_dot variant; kernel {f['ms']:.4f} ms ({', '.join(f'{x:.4f}' for x in times['ms'])}), "
            f"old composition {f['old_ms']:.4f} ms, the virtual rows alone (unsegmented "
            f"spike_gather) {f['vrows_ms']:.4f} ms, plain {f['plain_ms']:.3f} ms, "
            f"torch.sparse.mm over every bucket's real rows {f['library_ms']:.4f} ms; bound "
            f"{f['bound_ms']:.4f} ms ({f['bound_by']}: {nb / 1e9:.4f} GB): "
            f"{f['bound_ms'] / f['ms']:.0%}; launch {config}")

    del csrs
    if plastic:  # stdp_update_step over every bucket, as the unfused step calls it
        gen2 = torch.Generator(sim.device).manual_seed(3)
        pre_t, post_t = (torch.rand(n_p, generator=gen2, device=sim.device) for _ in range(2))
        act = vecs["5% active"]
        fig["stdp_update"] = stdp_step_figures(tag, dev, pre_t, act, post_t, act,
                                               sim.stdp_params)

    # graphed (capturing its keys, launches counted), uncaptured, graphed
    # again (replays): each run from the session's start state
    st0 = ses.state
    reset_counts()
    _, _, r_g, secs_c = run_session(ses, steps)
    launches = read_counts()
    want = dict(lif_step=steps, segment_gather=steps, noise_add=steps)
    if plastic:
        want["stdp_update"] = steps
    require(launches == only(**want), f"{tag}: launches {launches}")
    st_g = ses.state
    require(sim.graph_mode == "cuda_graph", f"{tag}: graph mode {sim.graph_mode}")
    nodes = {}
    for g in sim._graphs.graphs.values():
        kinds = graph_node_kinds(g.graph)
        require(kinds["memcpy_to_host"] == 0, f"{tag}: a memcpy to the host in {g.what}")
        nodes[g.what] = kinds["kernel"] / g.steps
    ses._state = st0
    with uncaptured(sim):
        _, _, r_u, secs_u = run_session(ses, steps)
    require(np.array_equal(r_g.raster, r_u.raster), f"{tag}: graphed and uncaptured rasters differ")
    require_states_bit_equal(st_g, ses.state, f"{tag}: graphed vs uncaptured end state")
    ses._state = st0
    _, _, r_r, secs_g = run_session(ses, steps)
    require(np.array_equal(r_g.raster, r_r.raster), f"{tag}: the replayed raster differs")
    require_states_bit_equal(st_g, ses.state, f"{tag}: replayed vs captured end state")
    spikes = int(r_g.raster.sum())
    require(spikes > 0, f"{tag}: the net never spiked")
    differ = int((r_g.raster != unsplit_raster[:steps]).sum())
    say("maxk", f"{tag}: {steps} steps graphed {secs_g / steps * 1e6:.1f} us/step (replays; "
        f"{secs_c / steps * 1e6:.1f} with the captures), uncaptured "
        f"{secs_u / steps * 1e6:.1f} us/step (host clock, monitors); rasters ({spikes} spikes) "
        f"and end states (t, vtx_state, ring, hist, traces"
        f"{', weights' if plastic else ''}) bit-equal; kernel nodes a step "
        + ", ".join(f"{k}: {v:.2f}" for k, v in nodes.items())
        + f"; launches {launches}; against the unsplit path's raster: {differ} entries differ "
        "(the split sums each row in another order); max |launch - plain| "
        f"{err:.3e} (rtol=atol=1e-5)")
    MAXK[tag] = dict(fig=fig, launches=launches, err=err, us_graphed=secs_g / steps * 1e6,
                     us_uncaptured=secs_u / steps * 1e6, nodes=nodes)
    del ses, sim, dev, st0, st_g
    gc.collect()
    torch.cuda.empty_cache()


def maxk_entry():
    """The kernels line's ``segment_gather`` row: the microcircuit's 5%
    vector as its figure, the main-path vector and the Brunel net beside."""
    mc, br = MAXK["microcircuit"]["fig"], MAXK["brunel"]["fig"]
    src, rep = SOURCES["segment_gather"]
    row = dict(name="segment_gather", route="cuda", source=src, replaces=rep,
               launches=sum(m["launches"]["segment_gather"] for m in MAXK.values()),
               max_abs_err=max(m["err"] for m in MAXK.values()), path="maxk",
               vector="SimConfig(max_k=512) on the microcircuit, 5% active; _main_path: a "
               "main-path spike vector; _brunel: SimConfig(max_k=64, align_k=32) on the Brunel "
               "net; library_ms: torch.sparse.mm over every bucket's real rows; old_ms: the "
               "unsegmented spike_gather, segment_add_ref and index_add_ a bucket")
    for suffix, f in (("", mc["5% active"]), ("_main_path", mc["main-path step"]),
                      ("_brunel", br["5% active"]), ("_brunel_main_path", br["main-path step"])):
        for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "old_ms"):
            row[key + suffix] = f[key]
    return row


def phase_contracts(card):
    """[contracts] The card view of every row of the engine-contract matrix
    (``repro_torch.analysis.contracts``): the ops of uncaptured steps, the
    captured graphs' kernel nodes a step and memcpy nodes to the host, and
    an uncaptured chunk under ``set_sync_debug_mode("error")``."""
    t0 = time.perf_counter()
    violations, results = run_matrix(device=card, verbose=False)
    per_engine = {}
    for name, res in results.items():
        facts = res.facts
        nodes = ", ".join(f"{k:.2f}" for k in res.kernels_per_step.values())
        if facts is not None:
            say("contracts", f"{name}: {res.engine}, {facts.exchanges / facts.steps:g} "
                f"exchange(s) a step, {facts.ops / facts.steps:.1f} torch ops a step beside the "
                f"kernels, widest 1-D f32 {facts.max_f32_vector}; kernel nodes a step {nodes}; "
                + ("clean" if not res.problems else "; ".join(res.problems)))
        per_engine.setdefault(res.engine, []).extend(res.kernels_per_step.values())
    require(not violations, f"contract violations on the card: {violations}")
    say("contracts", f"{len(results)} rows of the matrix honour their engine contracts on the "
        f"card ({time.perf_counter() - t0:.1f} s); kernel nodes a step by engine (k=1 and k=2 "
        "rows of balanced_ei(160)): " + "; ".join(
            f"{e} {min(v):.2f}-{max(v):.2f}" for e, v in per_engine.items() if v))


# [lm]: the LM substrate's serving path at full width, each config with its
# own param_dtype and compute_dtype, weights drawn on the card from --seed
LM_ARCHS = ("smollm-135m", "granite-moe-3b-a800m", "recurrentgemma-2b", "xlstm-350m",
            "paligemma-3b", "whisper-small")
LM_BATCH, LM_PROMPT, LM_NEW, LM_FRAMES = 4, 16, 24, 16
LM_LONG = ("smollm-135m", 64, 512, 128)  # arch, batch, prompt, new tokens
# the last decode step against a cache-free forward over the same tokens,
# at full depth in the config's compute dtype (bf16 for all six): the cache
# path rounds its activations, and the recurrent states of rglru and xlstm,
# to bf16 at every step, the forward only within each layer.  xlstm-350m
# stores its mLSTM matrix memory C and normalizer n in bf16 between decode
# steps, as the reference does (repro/models/xlstm.py:166-168), where the
# forward carries them in fp32 through the sequence: its gap is the widest
# and grows with depth.  At the published widths on the CPU
# (tests/lm_cache_gap.py, seed 0, batch 2, 24 steps) the reference reads
# 5.8e-3, 1.1e-2, 1.7e-2, 3.5e-2 at 2, 4, 8, 12 layers and the port on the
# same params 4.8e-3, 1.0e-2, 2.0e-2, 3.1e-2; at 24 layers on the card the
# port reads 5.9e-2.  The limit sits above both with room; a fault in the
# bf16 state would part the port from the reference at every depth.
# stablelm-12b and phi3-medium-14b (40 layers, bf16 params): their logits
# at random init peak near 4, where a bf16 step is 2^-5, 0.0078 of the
# peak, so the default limit is under three bf16 steps of the output; on
# an NVIDIA H100 80GB HBM3 at 700 W they read 2.10e-2 and 2.03e-2, and at
# full depth in fp32 compute 2.71e-6 and 2.65e-6 (``lm_fp32_gap``, held to
# LM_CARD_CPU_TOL for the three dense LMs), so the gap is bf16 rounding,
# not the cache.  Their limit is about six bf16 steps at the peak
LM_CACHE_TOL = {"xlstm-350m": 1e-1, "stablelm-12b": 5e-2, "phi3-medium-14b": 5e-2}
LM_CACHE_TOL_DEFAULT = 2e-2
# card against CPU at full width, 2 periods deep, fp32 compute, TF32 off:
# the same math, summed in other orders by cuBLAS and the CPU's BLAS; and
# at fp32 on the card, the cache path against the cache-free forward
LM_CARD_CPU_TOL = 1e-4  # max |delta| <= tol * max |logits|


def lm_inputs(cfg, batch, prompt_len, seed, dev):
    """A prompt and the stub frontend's embeddings, drawn on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device=dev,
                           dtype=torch.int32)
    extras = None
    if cfg.encdec:
        extras = dict(frames=torch.randn((batch, LM_FRAMES, cfg.d_model), generator=gen,
                                         device=dev))
    elif cfg.n_img_tokens:
        extras = dict(img_embed=torch.randn((batch, cfg.n_img_tokens, cfg.d_model),
                                            generator=gen, device=dev))
    return prompt, extras


def lm_no_drop(model, cfg):
    """``(cfg, model)``, or for an MoE the config at a capacity factor of
    ``E / k``, where no assignment drops, and a model of it that holds
    ``model``'s parameters (shared, not copied)."""
    if not cfg.moe:
        return cfg, model
    check = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    dev = next(model.parameters()).device
    twin = build_model(check, device=dev, generator=torch.Generator(dev).manual_seed(0))
    twin.load_state_dict(model.state_dict(), assign=True)
    return check, twin


class OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched inside it (each one host-side call,
    and at least one device kernel for most)."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def lm_replay(model, cfg, prompt, extras, toks, cache_len, sync_check=False):
    """The prefill, then one decode step per token of ``toks`` at the
    positions the cache holds them (``S + n_img`` on the VLM, not F10's
    ``S``), the first under ``set_sync_debug_mode("error")`` when asked;
    the prefill's and the steps' seconds, each step's argmax, the last
    step's logits and the aten ops of the first step."""
    S, new = prompt.shape[1], toks.shape[1]
    prefill = make_prefill_fn(model, cfg, cache_len=cache_len)
    step = make_serve_step(model, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, logits = prefill(prompt, extras)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pos = torch.full((), S + (cfg.n_img_tokens or 0), dtype=torch.int32, device=prompt.device)
    if sync_check:
        torch.cuda.set_sync_debug_mode("error")
    try:
        with OpCount() as count:
            logits, cache = step(cache, toks[:, :1], pos)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    picks = [logits.argmax(-1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, new):
        pos = pos + 1
        logits, cache = step(cache, toks[:, i:i + 1], pos)
        picks.append(logits.argmax(-1))
    torch.cuda.synchronize()
    return prefill_s, time.perf_counter() - t0, picks, logits, count.ops


@contextlib.contextmanager
def compute_in(model, dtype: str):
    """``model`` computing in ``dtype`` for the body: each submodule's
    ``cfg`` swapped for one with that ``compute_dtype`` (the parameters keep
    theirs and are cast where they are used)."""
    saved = [(m, m.cfg) for m in model.modules() if hasattr(m, "cfg")]
    for m, c in saved:
        m.cfg = dataclasses.replace(c, compute_dtype=dtype)
    try:
        yield
    finally:
        for m, c in saved:
            m.cfg = c


def lm_fp32_gap(model, cfg, prompt, extras, toks, cache_len):
    """The cache path's last decode step against the cache-free forward at
    full depth in fp32 compute, TF32 off (the bf16 parameters cast where
    used): max |delta| / max |logits|.  A fault in the cache shows here at
    the fp32 size, where bf16 rounding no longer hides it."""
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with compute_in(model, "float32"), torch.no_grad():
            logits = lm_replay(model, cfg32, prompt, extras, toks, cache_len)[3].float()
            full, _, _ = model(torch.cat([prompt, toks], dim=1), logits_slice=1,
                               **(extras or {}))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    full = full[:, -1].float()
    return float((logits - full).abs().max()) / float(full.abs().max())


def lm_serve(model, cfg, prompt, extras, new, fp32_gap=False):
    """``greedy_generate`` (its tokens and seconds, peak device memory),
    then the same path in pieces (``lm_replay``): the prefill timed, one
    decode step under ``set_sync_debug_mode("error")`` and the other ``new
    - 1`` timed; the last step's logits against a cache-free forward over
    the whole sequence.  An MoE drops assignments past its per-sequence
    capacity, which differs between a prefill, a decode step and the whole
    sequence, so its check replays under a capacity factor of ``E / k``,
    where nothing drops (the same parameters)."""
    B, S = prompt.shape
    n_img = cfg.n_img_tokens or 0
    cache_len = S + new + n_img
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toks = greedy_generate(model, cfg, prompt, new, extras=extras, cache_len=cache_len)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    require(toks.shape == (B, new) and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
            f"{cfg.name}: greedy tokens {tuple(toks.shape)} out of range")
    prefill_s, decode_s, picks, logits, ops = lm_replay(model, cfg, prompt, extras, toks,
                                                        cache_len, sync_check=True)
    check, twin = lm_no_drop(model, cfg)
    with torch.no_grad():
        if cfg.moe:
            logits = lm_replay(twin, check, prompt, extras, toks, cache_len)[3]
        full, _, _ = twin(torch.cat([prompt, toks], dim=1), logits_slice=1, **(extras or {}))
    del twin
    full = full[:, -1].float()
    require(bool(torch.isfinite(full).all()) and bool(torch.isfinite(logits.float()).all()),
            f"{cfg.name}: non-finite logits")
    delta = float((logits.float() - full).abs().max())
    scale = float(full.abs().max())
    tol = LM_CACHE_TOL.get(cfg.name, LM_CACHE_TOL_DEFAULT)
    require(delta <= tol * scale,
            f"{cfg.name}: the last decode step differs from the cache-free forward by {delta} "
            f"(max |logits| {scale}, tol {tol} x)")
    same = bool(torch.equal(torch.stack(picks[:-1], 1).to(torch.int32), toks[:, 1:]))
    gap32 = None
    if fp32_gap:
        gap32 = lm_fp32_gap(model, cfg, prompt, extras, toks, cache_len)
        require(gap32 <= LM_CARD_CPU_TOL, f"{cfg.name}: at fp32 compute and full depth the last "
                f"decode step differs from the cache-free forward by {gap32:.3g} of max |logits| "
                f"(tol {LM_CARD_CPU_TOL})")
    return dict(gen_s=gen_s, prefill_ms=prefill_s * 1e3, decode_ms=decode_s / (new - 1) * 1e3,
                tok_s=B * (new - 1) / decode_s, peak_gb=peak / 1e9, delta=delta, scale=scale,
                tol=tol, replay_equal=same, ops=ops, gap32=gap32)


def lm_card_vs_cpu(cfg, card, seed):
    """``cfg`` at full width, 2 periods deep, fp32 compute: the parameters
    drawn on the card and copied to the CPU; a prefill (the text
    positions' logits) and two decode steps on fixed tokens on both."""
    P = cfg.pattern_period
    cfg2 = dataclasses.replace(cfg, n_layers=2 * P, compute_dtype="float32",
                               enc_layers=min(cfg.enc_layers, 2))
    model = build_model(cfg2, device=card, generator=torch.Generator(card).manual_seed(seed))
    B, S, n_img = 2, 8, cfg.n_img_tokens or 0
    prompt, extras = lm_inputs(cfg2, B, S + 2, seed + 1, card)

    def run(model, dev):
        p = prompt.to(dev)
        kw = {k: v.to(dev) for k, v in (extras or {}).items()}
        cache = (model.init_cache(B, S + 2, LM_FRAMES) if cfg.encdec
                 else model.init_cache(B, S + n_img + 2))
        with torch.no_grad():
            lg, cache, _ = model(p[:, :S], cache=cache, logits_slice=S, **kw)
            outs = [lg]
            for i in range(2):
                lg, cache, _ = model(p[:, S + i:S + i + 1], cache=cache,
                                     cache_pos=torch.tensor(S + n_img + i, device=dev))
                outs.append(lg)
        return [o.float().cpu() for o in outs]

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        on_card = run(model, card)
        # the cache path against the cache-free forward, fp32 (an MoE with
        # nothing dropped, as in lm_serve)
        _, twin = lm_no_drop(model, cfg2)
        with torch.no_grad():
            last = run(twin, card)[-1] if cfg2.moe else on_card[-1]
            full, _, _ = twin(prompt, logits_slice=1, **(extras or {}))
        del twin
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    full = full[:, -1].float().cpu()
    d, m = float((last[:, -1] - full).abs().max()), float(full.abs().max())
    require(d <= LM_CARD_CPU_TOL * m, f"{cfg.name}: at fp32 on the card the last decode step "
            f"differs from the cache-free forward by {d} (max |logits| {m}, tol "
            f"{LM_CARD_CPU_TOL} x)")
    fp32_cache = d / m
    model.cpu()
    t0 = time.perf_counter()
    on_cpu = run(model, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    rel = []
    for a, b in zip(on_card, on_cpu):
        d, m = float((a - b).abs().max()), float(b.abs().max())
        require(d <= LM_CARD_CPU_TOL * m, f"{cfg.name}: card vs CPU max |delta| {d} over "
                f"max |logits| {m} (tol {LM_CARD_CPU_TOL} x)")
        rel.append(d / m)
    del model
    return cfg2.n_layers, rel, cpu_s, fp32_cache


def lm_config(name, B, S, new, vs_cpu, card, seed, smi):
    """One ``[lm]`` line: ``name`` at full width built on the card (the
    card's free memory before the build in the line), served through
    ``lm_serve``, then (``vs_cpu``) held against the CPU at 2 periods."""
    cfg = get_config(name)
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg, device=card, generator=torch.Generator(card).manual_seed(seed))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    prompt, extras = lm_inputs(cfg, B, S, seed + 1, card)
    f = lm_serve(model, cfg, prompt, extras, new, fp32_gap=name in LM_DENSE)
    del model, prompt, extras
    gc.collect()
    torch.cuda.empty_cache()
    tail = ""
    if vs_cpu:
        depth, rel, cpu_s, fp32_cache = lm_card_vs_cpu(cfg, card, seed)
        tail = (f"; card vs CPU ({depth} layers, fp32 compute, TF32 off): max |delta| / max "
                f"|logits| prefill {rel[0]:.2e}, decode {rel[1]:.2e}, {rel[2]:.2e}, and the "
                f"card's last decode step vs its cache-free forward {fp32_cache:.2e} (tol "
                f"{LM_CARD_CPU_TOL:g}; CPU {cpu_s:.1f} s)")
        gc.collect()
        torch.cuda.empty_cache()
    say("lm", f"{name} ({cfg.family}; {cfg.n_layers} layers, d {cfg.d_model}, params "
        f"{cfg.param_dtype}, compute {cfg.compute_dtype}): card memory free before the build "
        f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB; {n_params / 1e6:.1f} M params "
        f"({n_bytes / 2**30:.2f} GiB) drawn in {build_s:.2f} s; batch {B}, prompt {S}"
        + (f" + {cfg.n_img_tokens} image tokens" if cfg.n_img_tokens else "")
        + (f", {LM_FRAMES} frames" if cfg.encdec else "")
        + f", {new} new: greedy_generate {f['gen_s']:.3f} s; prefill {f['prefill_ms']:.2f} "
        f"ms, decode {f['decode_ms']:.3f} ms a token (step), {f['tok_s']:.1f} tok/s, peak "
        f"{f['peak_gb']:.3f} GB ({f['peak_gb'] * 1e9 / 2**30:.2f} GiB); last step vs "
        f"cache-free forward max |delta| "
        f"{f['delta']:.4g} of max |logits| {f['scale']:.4g} (tol {f['tol']:g} x)"
        + ("" if f["gap32"] is None else f", in fp32 compute at full depth {f['gap32']:.2e} "
           f"(tol {LM_CARD_CPU_TOL:g})")
        + f"; replay's tokens equal greedy's: {f['replay_equal']}; a decode step clean under "
        f"sync debug 'error', {f['ops']} aten ops ({f['decode_ms'] * 1e3 / f['ops']:.1f} us "
        f"of the step each){tail}; {smi}")


def phase_lm(card, seed, smi):
    """[lm] The LM substrate's serving path on the card: six configs at
    full width through ``greedy_generate`` (batch 4, prompt 16, 24 new
    tokens), each with its cache checked against a cache-free forward, a
    decode step under sync debug and the port held against the CPU at 2
    periods; then smollm-135m at batch 64, prompt 512, 128 new tokens.
    The three dense LMs of ``LM_DENSE`` run in ``--lm-child serve``."""
    t_phase = time.perf_counter()
    runs = [(name, LM_BATCH, LM_PROMPT, LM_NEW, True) for name in LM_ARCHS]
    runs.append(LM_LONG + (False,))
    for name, B, S, new, vs_cpu in runs:
        lm_config(name, B, S, new, vs_cpu, card, seed, smi)
    say("lm", f"phase {time.perf_counter() - t_phase:.1f} s")


# [train]: the LM substrate's training slice at full width
TRAIN_SMOLLM = ("smollm-135m", 8, 128, 8, 4)  # arch, batch, seq, steps, checkpoint step
TRAIN_GRANITE = ("granite-moe-3b-a800m", 4, 128, 3)  # arch, batch, seq, steps (8-bit moments)
TRAIN_LR = 3e-4  # the launcher's default, under its cosine schedule
# the straight run against the run restored at step 4: each parameter's
# change since step 4 within this share of its leaf's largest change.  The
# card's embedding backward adds with atomics, in no fixed order, so the
# runs need not be bit-equal; on an NVIDIA H100 80GB HBM3 at 700 W the gap
# has read 0 in every run so far.  Each planted resume fault must read over
# the limit: the count restored one short (bias correction and schedule a
# step off) read 1.17 there, one leaf's moments (ln_f's) restored as zeros
# 1.0; the limit sits between, well under either.
TRAIN_RESUME_TOL = 1e-3
TRAIN_RESUME_FAULTS = ("count one short", "ln_f moments zeroed")
# card against CPU at 2 periods, fp32 compute, TF32 off: a leaf's gradient
# within this share of its largest |g| (floored at 1e-3 of the model's
# largest), the loss within it relative; then the update on the same
# gradients: parameters within 2^-21 of max(1, max |p|) (four ulps at 1:
# the card's and the CPU's pow and gradient norm round apart), fp32 moments
# within 1e-6 of their leaf's largest, 8-bit q one step apart in at most
# 1 in 10^4 entries and scale within 2 ulps
TRAIN_CARD_CPU_TOL = 1e-4


def train_batches(cfg, batch, seq, steps, card, start=0):
    """``host_batch`` of steps ``start .. steps - 1`` (the affine task),
    moved to the card before any timed step."""
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch)
    return dc, [{k: v.to(card) for k, v in host_batch(dc, s).items()}
                for s in range(start, steps)]


def param_prints(params):
    """Per parameter, its sum and norm in fp64 (a fingerprint that any
    update moves)."""
    with torch.no_grad():
        return torch.stack([torch.stack([p.sum(dtype=torch.float64),
                                         torch.linalg.vector_norm(p, dtype=torch.float64)])
                            for p in params])


def resume_gaps(model, straight, base):
    """Per parameter, ``max |change in model - change in straight|`` over
    ``max |change in straight|``, each change since ``base``."""
    gaps = {}
    for k, want in straight.items():
        d_want = (want - base[k]).double()
        d_got = (model.state_dict()[k] - base[k]).double()
        gaps[k] = float((d_got - d_want).abs().max()) / max(float(d_want.abs().max()), 1e-30)
    return gaps


def plant_resume_fault(fault, state):
    """``state`` (a restored AdamW state) with ``fault`` planted."""
    if fault == "count one short":
        state["count"] = state["count"] - 1
    else:
        i = next(i for i, leaf in enumerate(state["leaves"]) if leaf.path[0] == "ln_f")
        state["m"][i].zero_()
        state["v"][i].zero_()
    return state


def train_smollm(card, seed, smi):
    """(a) smollm-135m at full width and depth: 8 steps straight with an
    async checkpoint at step 4, then steps 4-7 again from the checkpoint,
    and once more for each planted resume fault, which must read over the
    limit."""
    name, B, S, steps, at = TRAIN_SMOLLM
    cfg = get_config(name)
    model = build_model(cfg, device=card, generator=torch.Generator(card).manual_seed(seed))
    opt = AdamW(lr=cosine_schedule(TRAIN_LR, warmup=min(50, steps // 10 + 1), total=steps))
    state = opt.init(lm_param_leaves(cfg, model))
    dc, batches = train_batches(cfg, B, S, steps, card)
    step_fn = make_train_step(model, cfg, opt)
    root = SNAP_ROOT / "train"
    shutil.rmtree(root, ignore_errors=True)
    cm = CheckpointManager(str(root), max_to_keep=2)
    losses, step_s = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for s in range(steps):
        if s == at:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cm.save(at, convert.lm_train_tree(cfg, model, state))
            stall = time.perf_counter() - t0
            cm.wait()
            write = time.perf_counter() - t0 - stall
            base = {k: v.detach().clone() for k, v in model.state_dict().items()}
        if s == 1:  # warmed: the first step allocates
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            state, metrics = step_fn(state, batches[s])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(metrics["loss"])
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    require(all(math.isfinite(x) for x in losses), f"{name}: a loss is not finite: {losses}")
    require(np.mean(losses[-5:]) < losses[0],
            f"{name}: the last 5 losses {losses[-5:]} are not under the first, {losses[0]}")
    n_bytes = snapshot_bytes(cm.step_dir(at))
    straight = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model, state, step_fn
    gc.collect()

    twin = build_model(cfg, device=card, generator=torch.Generator(card).manual_seed(seed + 9))
    t0 = time.perf_counter()
    like = convert.lm_train_tree(cfg, twin, opt.init(lm_param_leaves(cfg, twin)),
                                 like=True)
    tree, got = cm.restore(at, like=like)
    twin.load_state_dict(convert.lm_params_from_arrays(cfg, tree["params"]))
    restored = convert.lm_opt_state_from_arrays(cfg, twin, tree["opt_state"])
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    require(got == at and int(restored["count"]) == at, f"{name}: restored step {got}")
    planted = []
    for fault in TRAIN_RESUME_FAULTS:
        bad = build_model(cfg, device=card)
        bad.load_state_dict(twin.state_dict())
        planted.append((fault, bad, plant_resume_fault(
            fault, convert.lm_opt_state_from_arrays(cfg, bad, tree["opt_state"]))))
    del tree
    fit(twin, cfg, opt, batch_iterator(dc, start_step=at), steps=steps, opt_state=restored,
        log_every=0)
    gaps = resume_gaps(twin, straight, base)
    worst = max(gaps.values())
    for k, gap in gaps.items():
        require(gap <= TRAIN_RESUME_TOL, f"{name}: {k} after the resumed run differs from the "
                f"straight run by {gap:.3g} of its largest change since step {at} (tol "
                f"{TRAIN_RESUME_TOL})")
    fault_gaps = {}
    for fault, bad, bad_state in planted:
        fit(bad, cfg, opt, batch_iterator(dc, start_step=at), steps=steps, opt_state=bad_state,
            log_every=0)
        fault_gaps[fault] = max(resume_gaps(bad, straight, base).values())
        require(fault_gaps[fault] > TRAIN_RESUME_TOL, f"{name}: a resume with the planted fault "
                f"'{fault}' reads {fault_gaps[fault]:.3g}, within the limit {TRAIN_RESUME_TOL}")
    del planted, bad, bad_state
    cm.close()
    shutil.rmtree(root, ignore_errors=True)
    ms = 1e3 * float(np.mean(step_s[1:]))
    say("train", f"{name} ({cfg.n_layers} layers, d {cfg.d_model}, params {cfg.param_dtype}, "
        f"compute {cfg.compute_dtype}; {sum(p.numel() for p in twin.parameters()) / 1e6:.1f} M "
        f"params), batch {B} x seq {S}, AdamW fp32 moments, lr {TRAIN_LR:g} cosine: losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; {ms:.1f} ms a step (steps 2-{steps}, host clock with a sync; first "
        f"{1e3 * step_s[0]:.1f} ms), {B * S / (ms / 1e3):.0f} tokens/s, peak "
        f"{peak / 1e9:.3f} GB; step 2 clean under sync debug 'error'; checkpoint at step {at}: "
        f"{n_bytes} bytes, save stall {stall:.3f} s, write {write:.3f} s "
        f"({n_bytes / 1e9 / max(write, 1e-9):.3f} GB/s, fsync {'on' if fsync_enabled() else 'off'}), "
        f"restore {restore_s:.3f} s; resumed from it to step {steps}: largest parameter gap "
        f"{worst:.3g} of its leaf's change since step {at} (tol {TRAIN_RESUME_TOL}); planted "
        "faults: " + ", ".join(f"{f} {g:.3g}" for f, g in fault_gaps.items()) + f"; {smi}")
    del twin, straight, base, restored
    gc.collect()
    torch.cuda.empty_cache()


def train_granite(card, seed, smi):
    """(b) granite-moe-3b-a800m at full width and depth, 8-bit moments."""
    name, B, S, steps = TRAIN_GRANITE
    cfg = get_config(name)
    model = build_model(cfg, device=card, generator=torch.Generator(card).manual_seed(seed))
    opt = AdamW(lr=cosine_schedule(TRAIN_LR, warmup=1, total=steps), quantize_moments=True)
    state = opt.init(lm_param_leaves(cfg, model))
    _, batches = train_batches(cfg, B, S, steps, card)
    step_fn = make_train_step(model, cfg, opt)
    before = param_prints(model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s, out = [], []
    for s in range(steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batches[s])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        out.append({k: float(v) for k, v in metrics.items()})
    peak = torch.cuda.max_memory_allocated()
    moved = (param_prints(model.parameters()) != before).any(dim=1)
    n_params = sum(p.numel() for p in model.parameters())
    require(all(math.isfinite(m["loss"]) for m in out), f"{name}: a loss is not finite")
    require(all(k in out[-1] for k in ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")),
            f"{name}: the MoE aux losses are missing from the metrics {sorted(out[-1])}")
    require(bool(moved.all()), f"{name}: {int((~moved).sum())} parameters did not move")
    q_bytes = sum(x["q"].numel() + 4 * x["scale"].numel() for key in ("m", "v")
                  for x in state[key])
    ms = 1e3 * float(np.mean(step_s[1:]))
    say("train", f"{name} ({cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_experts} experts top "
        f"{cfg.top_k}; {n_params / 1e9:.3f} B params {cfg.param_dtype}), batch {B} x seq {S}, "
        f"AdamW 8-bit moments ({q_bytes / 1e9:.3f} GB): losses "
        + ", ".join(f"{m['loss']:.4f}" for m in out)
        + f"; lb {out[-1]['moe_lb_loss']:.4f}, z {out[-1]['moe_z_loss']:.4f}, drop fraction "
        f"summed over layers {out[-1]['moe_drop_frac']:.4f} (a layer's mean "
        f"{out[-1]['moe_drop_frac'] / cfg.n_layers:.4f}); {ms:.1f} ms a step (steps 2-{steps}; "
        f"first {1e3 * step_s[0]:.1f} ms), {B * S / (ms / 1e3):.0f} tokens/s, peak "
        f"{peak / 1e9:.3f} GB; every parameter moved; {smi}")
    del model, state, step_fn, batches
    gc.collect()
    torch.cuda.empty_cache()


def _leaf_gap(a, b):
    """``(max |a - b|, max |b|)`` in fp64 on ``a``'s device, ``b`` copied
    there (the card's reductions are quicker than the CPU's)."""
    b = b.to(a.device)
    return float((a.double() - b.double()).abs().max()), float(b.abs().max())


def train_card_vs_cpu(name, card, seed, quantize):
    """(c) ``name`` at full width, 2 periods deep (an encoder 2 layers
    deep), fp32 params and compute, the stub frontend's inputs drawn from
    the seed: one step's loss and gradients on the card and on the CPU from
    the same parameters and batch; then the update on both given the CPU's
    gradients.  Returns the largest relative gaps."""
    full = get_config(name)
    cfg = dataclasses.replace(full, n_layers=2 * full.pattern_period, compute_dtype="float32",
                              param_dtype="float32", enc_layers=min(full.enc_layers, 2))
    model = build_model(cfg, device=card, generator=torch.Generator(card).manual_seed(seed))
    cpu_model = build_model(cfg, device="meta")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, assign=True)
    batch = host_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2), 0)
    batch.update(lm_inputs(cfg, 2, 1, seed + 2, torch.device("cpu"))[1] or {})
    opt = AdamW(lr=1e-3, quantize_moments=quantize)
    runs = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for m, dev in ((model, card), (cpu_model, torch.device("cpu"))):
            state = opt.init(lm_param_leaves(cfg, m))
            loss, _ = make_loss_fn(m, cfg)({k: v.to(dev) for k, v in batch.items()})
            grads = torch.autograd.grad(loss, flat_params(state), allow_unused=True,
                                        materialize_grads=True)
            runs.append((m, state, float(loss.detach()), [g.detach() for g in grads]))
        (_, s_card, l_card, g_card), (_, s_cpu, l_cpu, g_cpu) = runs
        require(abs(l_card - l_cpu) <= TRAIN_CARD_CPU_TOL * abs(l_cpu),
                f"{name}: loss {l_card} on the card, {l_cpu} on the CPU")
        floor = 1e-3 * max(float(g.abs().max()) for g in g_cpu)
        g_rel = 0.0
        for p_name, a, b in zip((leaf.name for leaf in s_cpu["leaves"]
                                 for _ in leaf.params), g_card, g_cpu):
            gap, b_max = _leaf_gap(a, b)
            rel = gap / max(b_max, floor)
            g_rel = max(g_rel, rel)
            require(rel <= TRAIN_CARD_CPU_TOL, f"{name}: gradient of {p_name} on the card vs "
                    f"the CPU {rel:.3g} of its largest (tol {TRAIN_CARD_CPU_TOL})")
        opt.update([g.to(card) for g in g_cpu], s_card)
        opt.update(g_cpu, s_cpu)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    p_gap = 0.0
    for a, b in zip(flat_params(s_card), flat_params(s_cpu)):
        gap, b_max = _leaf_gap(a.detach(), b.detach())
        p_gap = max(p_gap, gap / max(1.0, b_max))
        require(gap <= 2.0**-21 * max(1.0, b_max),
                f"{name}: a parameter after the update differs by {gap} card vs CPU")
    m_note = ""
    if quantize:
        n_diff = n_all = 0
        s_rel = 0.0
        for key in ("m", "v"):
            for a, b in zip(s_card[key], s_cpu[key]):
                d = (a["q"].int() - b["q"].to(card).int()).abs()
                require(int(d.max()) <= 1, f"{name}: 8-bit {key} q apart by {int(d.max())}")
                n_diff += int((d > 0).sum())
                n_all += d.numel()
                gap, b_max = _leaf_gap(a["scale"], b["scale"])
                s_rel = max(s_rel, gap / max(b_max, 1e-30))
        require(n_diff <= max(n_all // 10**4, 1) and s_rel <= 2.4e-7,
                f"{name}: 8-bit moments card vs CPU: {n_diff} of {n_all} q apart, scale "
                f"{s_rel:.3g} relative")
        m_note = f"8-bit q apart in {n_diff} of {n_all} entries, scale {s_rel:.2e} relative"
    else:
        m_rel = 0.0
        for key in ("m", "v"):
            for a, b in zip(s_card[key], s_cpu[key]):
                gap, b_max = _leaf_gap(a, b)
                rel = gap / max(b_max, 1e-30)
                m_rel = max(m_rel, rel)
                require(rel <= 1e-6, f"{name}: {key} card vs CPU {rel:.3g} of its largest")
        m_note = f"moments {m_rel:.2e} of their largest"
    del runs, model, cpu_model, s_card, s_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return (f"{name} ({cfg.n_layers} layers, fp32, batch 2 x 32): loss "
            f"{abs(l_card - l_cpu) / abs(l_cpu):.2e} relative, gradients {g_rel:.2e} of their "
            f"leaf's largest, after the update parameters {p_gap:.2e} of max(1, |p|), "
            f"{m_note}")


def phase_train(card, seed, smi):
    """[train] The LM substrate's training slice on the card: (a) smollm
    with the resume check, (b) granite with 8-bit moments, (c) card
    against CPU."""
    t_phase = time.perf_counter()
    require_disk(4 << 30)
    train_smollm(card, seed, smi)
    train_granite(card, seed, smi)
    notes = [train_card_vs_cpu(TRAIN_SMOLLM[0], card, seed, False),
             train_card_vs_cpu(TRAIN_GRANITE[0], card, seed, True)]
    say("train", "card vs CPU (TF32 off; tol: loss and gradients "
        f"{TRAIN_CARD_CPU_TOL:g}, parameters 2^-21 of max(1, |p|)): " + "; ".join(notes)
        + f"; {smi}")
    say("train", f"phase {time.perf_counter() - t_phase:.1f} s")


# The configurations that fit one card and had run there only in part:
# the three dense LMs served (before, only reduced, in the CPU tests) and
# four families trained (before, they only served on the card).  Each set
# runs in a child process on the card (``--lm-child serve`` and
# ``--lm-child train``) while the parent builds on the host and the card
# idles: the serving child beside the microcircuit's ``to_dcsr`` and
# merge (about 90 s), the training child beside p3's numpy assembly
# (about 75 s); the parent joins each before its next allocation or timed
# run on the card.
LM_DENSE = ("stablelm-12b", "phi3-medium-14b", "command-r-35b")
TRAIN_FAMILIES = ("recurrentgemma-2b", "xlstm-350m", "paligemma-3b", "whisper-small")
TRAIN_FAMILY_SHAPE = (4, 128, 3)  # batch, seq, steps
TRAIN_SLOW_S = 3.0  # a second step over this: stop after it (2 steps)
# A bf16 parameter may stay put through the first steps, as in the
# reference, which also updates in fp32 and rounds back (``p.astype(f32) -
# lr * upd``, ``repro/train/optimizer.py:128``): where every element is at
# least this large in magnitude, half its bf16 spacing is at least 2^-9 =
# 1.95e-3, and an early AdamW step, about lr * (1 + wd * |p|) = 3.3e-4 at
# |p| = 1, rounds away.  Such a parameter (the norm scales, which start at
# 1.0) passes if its fp32 first moment is non-zero: the gradient reached it
TRAIN_BF16_STILL = 0.5
LM_CHILD_BUDGET_S = 300  # each child's limit
LM_CHILD_THREADS = 6  # the child's torch threads, one core or two left to the parent's build
LM_CHILD = []  # the running children, stopped at exit


def first_moments(state):
    """Per parameter (``flat_params`` order), its fp32 AdamW first moment."""
    out = []
    for leaf, m in zip(state["leaves"], state["m"]):
        out += list(m) if leaf.stacked else [m]
    return out


def train_family(name, card, seed, smi):
    """``name`` at full width and depth, its own param dtype, bf16 compute:
    batch 4 x seq 128 of the affine task (the stub frontend's frames or
    image embeddings drawn from the seed), AdamW fp32 moments under the
    launcher's cosine schedule, 3 steps (2 where the second takes over
    ``TRAIN_SLOW_S``), the second under ``set_sync_debug_mode("error")``;
    every loss finite, every parameter moved (or, bf16, held as
    ``TRAIN_BF16_STILL`` says)."""
    B, S, steps = TRAIN_FAMILY_SHAPE
    cfg = get_config(name)
    gc.collect()
    torch.cuda.empty_cache()
    model = build_model(cfg, device=card, generator=torch.Generator(card).manual_seed(seed))
    opt = AdamW(lr=cosine_schedule(TRAIN_LR, warmup=1, total=steps))
    state = opt.init(lm_param_leaves(cfg, model))
    _, batches = train_batches(cfg, B, S, steps, card)
    extras = lm_inputs(cfg, B, 1, seed + 2, card)[1] or {}
    step_fn = make_train_step(model, cfg, opt)
    params = flat_params(state)
    before = param_prints(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s, losses = [], []
    for s in range(steps):
        if s == 2 and step_s[1] > TRAIN_SLOW_S:
            break
        if s == 1:  # warmed: the first step allocates
            torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            state, metrics = step_fn(state, dict(batches[s], **extras))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(metrics["loss"])
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    require(all(math.isfinite(x) for x in losses), f"{name}: a loss is not finite: {losses}")
    moved = (param_prints(params) != before).any(dim=1).tolist()
    still = []
    for p, m, mv in zip(params, first_moments(state), moved):
        if mv:
            continue
        low = float(p.detach().abs().min())
        require(p.dtype == torch.bfloat16 and low >= TRAIN_BF16_STILL
                and bool((m != 0).any()),
                f"{name}: a {p.dtype} parameter of shape {tuple(p.shape)} did not move (min "
                f"|p| {low:.3g}, first moment non-zero: {bool((m != 0).any())})")
        still.append(p.numel())
    n_params = sum(p.numel() for p in params)
    ms = 1e3 * float(np.mean(step_s[1:]))
    say("train", f"{name} ({cfg.family}; {cfg.n_layers} layers, d {cfg.d_model}, params "
        f"{cfg.param_dtype}, compute {cfg.compute_dtype}; {n_params / 1e9:.3f} B params), batch "
        f"{B} x seq {S}" + (f" + {cfg.n_img_tokens} image tokens" if cfg.n_img_tokens else "")
        + (f", {LM_FRAMES} frames" if cfg.encdec else "")
        + f", AdamW fp32 moments, lr {TRAIN_LR:g} cosine, {len(step_s)} steps: losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; {ms:.1f} ms a step (steps 2-{len(step_s)}, host clock with a sync; first "
        f"{1e3 * step_s[0]:.1f} ms), {B * S / (ms / 1e3):.0f} tokens/s, peak {peak / 1e9:.3f} GB "
        f"({peak / 2**30:.2f} GiB); step 2 clean under sync debug 'error'; every parameter "
        f"moved" + (f" but {len(still)} bf16 ones of {sum(still)} elements, each at least "
                    f"{TRAIN_BF16_STILL} in magnitude (an update under half a bf16 step, "
                    "as in the reference), whose fp32 first moments moved" if still else "")
        + f"; {smi}")
    del model, state, step_fn, batches, params, extras
    gc.collect()
    torch.cuda.empty_cache()


def lm_child(part: str, seed: int, t_offset: float) -> int:
    """The body of ``--lm-child``: ``serve``, ``LM_DENSE`` served as
    ``[lm]`` serves; ``train``, ``TRAIN_FAMILIES`` trained and each held
    against the CPU.  The lines carry the parent's clock (``t_offset``: the
    parent's seconds at the start)."""
    global T_START
    T_START = time.perf_counter() - t_offset
    torch.set_num_threads(LM_CHILD_THREADS)
    card = torch.device("cuda", torch.cuda.current_device())
    smi = nvidia_smi()
    t0 = time.perf_counter()
    if part == "serve":
        for name in LM_DENSE:
            lm_config(name, LM_BATCH, LM_PROMPT, LM_NEW, True, card, seed, smi)
        say("lm", f"child: {', '.join(LM_DENSE)} in {time.perf_counter() - t0:.1f} s")
        return 0
    notes = []
    for name in TRAIN_FAMILIES:
        train_family(name, card, seed, smi)
        notes.append(train_card_vs_cpu(name, card, seed, False))
    say("train", "card vs CPU (TF32 off; tol: loss and gradients "
        f"{TRAIN_CARD_CPU_TOL:g}, parameters 2^-21 of max(1, |p|)): " + "; ".join(notes)
        + f"; {smi}")
    say("train", f"child: {', '.join(TRAIN_FAMILIES)} in {time.perf_counter() - t0:.1f} s")
    return 0


def start_lm_child(part: str, seed: int, beside: str):
    """Start ``--lm-child part``, its output into files under ``_snap/``."""
    out = SNAP_ROOT / f"lm_child_{part}"
    out.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, str(Path(__file__).resolve()), "--lm-child", part, "--seed", str(seed),
           "--t-offset", f"{time.perf_counter() - T_START:.3f}"]
    with open(out / "stdout", "w") as f_out, open(out / "stderr", "w") as f_err:
        proc = subprocess.Popen(cmd, stdout=f_out, stderr=f_err)
    LM_CHILD.append(proc)
    what = (f"{', '.join(LM_DENSE)} served" if part == "serve"
            else f"{', '.join(TRAIN_FAMILIES)} trained")
    say("lm" if part == "serve" else "train",
        f"started the child (pid {proc.pid}): {what} on the card, beside {beside}")
    return part, proc, out, time.perf_counter()


def join_lm_child(child):
    """Wait for the child, print its lines, and fail if it failed."""
    part, proc, out, t0 = child
    t_wait = time.perf_counter()
    try:
        rc = proc.wait(timeout=max(5.0, LM_CHILD_BUDGET_S - (t_wait - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    sys.stdout.write((out / "stdout").read_text())
    sys.stdout.flush()
    err = (out / "stderr").read_text()
    require(rc == 0, f"the LM child '{part}' failed (rc {rc}; limit {LM_CHILD_BUDGET_S} s): "
            f"{err[-3000:]}")
    LM_CHILD.remove(proc)
    say("lm" if part == "serve" else "train",
        f"the child '{part}' ran {time.perf_counter() - t0:.1f} s; the parent waited "
        f"{time.perf_counter() - t_wait:.1f} s for it after its host build")


def stop_lm_child():
    for proc in LM_CHILD:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# [mesh]: the sharding policy on a one-card NCCL mesh, and the dry run
MESH_SMOLLM = ("smollm-135m", 8, 128, 2)  # arch, batch, seq, train steps each way
MESH_GRANITE = ("granite-moe-3b-a800m", 4, 16, 8)  # arch, batch, prompt, greedy decode steps
MESH_LR = 1e-3  # constant AdamW lr of the two train runs
# with and without the policy on a 1x1 ("data", "model") mesh, fp32 compute
# and TF32 off (in bf16 a one-ulp gap in a logit's gradient runs through
# every layer): the same ops on the same shards but for the loss's
# vocab-sharded logsumexp and argmax (``train/losses.py``), so each step's
# loss within 1e-5 relative; every parameter within 2 * MESH_LR after the 2
# steps (Adam's first steps move a parameter by about lr whatever its
# gradient's size, so a rounding-size gap in a near-zero gradient can move
# one element by up to a step), and at most 1 in 10^3 elements more than
# 1e-6 apart
MESH_LOSS_TOL = 1e-5
MESH_PARAM_TOL = 2 * MESH_LR
MESH_PARAM_SHARE = 1e-3
MESH_BUDGET_S = 60  # the [mesh] child's limit
# two dry-run cells on the 16x16 fake mesh (``repro_torch.launch.dryrun``),
# started in the background after the build and read in [mesh]
DRY_CELLS = (("smollm-135m", "train_4k", ""),
             ("granite-moe-3b-a800m", "decode_32k", "moe_impl=ep_shard_map"))
DRY = {}


def start_dry_runs():
    """Start the dry-run cells, one process each (host only: no card)."""
    out = SNAP_ROOT / "dryrun"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"),
               OMP_NUM_THREADS="1")
    for arch, shape, override in DRY_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
               "--mesh", "single", "--out", str(out)]
        if override:
            cmd += ["--override", override]
        DRY[(arch, shape)] = (subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                               stderr=subprocess.PIPE, text=True),
                              time.perf_counter(), out / f"{arch}__{shape}__single.json")


def stop_dry_runs():
    for proc, _, _ in DRY.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def mesh_child(seed: int, reduced: bool) -> int:
    """The body of ``--mesh-child``: a world-size-1 NCCL process group and a
    1x1 ``("data", "model")`` mesh on the card; (a) smollm-135m in fp32
    compute, 2 train steps with the policy (parameters as DTensors) against
    2 without; (b)
    granite-moe-3b-a800m served with ``moe_impl="ep_shard_map"`` under the
    policy against ``gspmd`` without one: a prefill and greedy decode
    steps (the prefill's token and ``MESH_GRANITE[3]`` more).  Prints one
    ``MESH {json}`` line.  ``reduced``: the configs' ``reduced()`` (the gpu
    tests)."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.sharding.policy import REPLICATED, make_policy, shard_model

    card = torch.device("cuda", 0)
    torch.cuda.set_device(card)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        res = {"device": torch.cuda.get_device_name(0)}
        name, B, S, steps = MESH_SMOLLM
        cfg = get_config(name).reduced() if reduced else get_config(name)
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
        torch.backends.cuda.matmul.allow_tf32 = False
        _, batches = train_batches(cfg, B, S, steps, card)
        runs = {}
        for tag in ("plain", "policy"):
            model = build_model(cfg, device=card, generator=torch.Generator(card).manual_seed(seed))
            pol = None
            if tag == "policy":
                pol = make_policy(mesh, cfg, B)
                shard_model(pol, model)
            opt = AdamW(lr=MESH_LR)
            state = opt.init(lm_param_leaves(cfg, model))
            step = make_train_step(model, cfg, opt, policy=pol)
            losses, ms = [], []
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step(state, b)
                losses.append(float(metrics["loss"]))  # waits for the step
                ms.append((time.perf_counter() - t0) * 1e3)
            flat = convert._flatten(convert.lm_params_to_arrays(cfg, model), "", {})
            runs[tag] = dict(losses=losses, ms=ms, params=flat)
            del model, state, step
            gc.collect()
            torch.cuda.empty_cache()
        a, b = runs["plain"], runs["policy"]
        gaps = {k: np.abs(a["params"][k].astype(np.float64) - b["params"][k]) for k in a["params"]}
        n_el = sum(g.size for g in gaps.values())
        res["train"] = dict(
            arch=name, batch=B, seq=S, layers=cfg.n_layers, losses_plain=a["losses"],
            losses_policy=b["losses"], ms_plain=a["ms"], ms_policy=b["ms"],
            loss_rel=max(abs(x - y) / abs(x) for x, y in zip(a["losses"], b["losses"])),
            param_gap=max(float(g.max()) for g in gaps.values()),
            param_share=sum(int((g > 1e-6).sum()) for g in gaps.values()) / n_el)
        name, B, P, new = MESH_GRANITE
        base = get_config(name).reduced() if reduced else get_config(name)
        prompt = torch.randint(0, base.vocab_size, (B, P), dtype=torch.int32,
                               generator=torch.Generator(card).manual_seed(seed + 1), device=card)
        serve = {}
        for tag in ("gspmd", "ep_shard_map"):
            cfg = dataclasses.replace(base, moe_impl=tag)
            model = build_model(cfg, device=card, generator=torch.Generator(card).manual_seed(seed))
            pol = None
            if tag == "ep_shard_map":
                pol = make_policy(mesh, cfg, B)
                shard_model(pol, model)
            prefill = make_prefill_fn(model, cfg, policy=pol, cache_len=P + new)
            decode = make_serve_step(model, cfg, policy=pol)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache, logits = prefill(prompt)
            cur = torch.argmax(logits, -1).to(torch.int32)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            toks, ms = [cur], []
            pos = torch.full((), P, dtype=torch.int32, device=card)
            for _ in range(new):
                t0 = time.perf_counter()
                logits, cache = decode(cache, cur[:, None], pos)
                pos = pos + 1
                cur = torch.argmax(logits, -1).to(torch.int32)
                toks.append(cur)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            serve[tag] = dict(tokens=torch.stack(toks, 1).cpu().tolist(), prefill_ms=prefill_ms,
                              decode_ms=ms)
            del model, cache
            gc.collect()
            torch.cuda.empty_cache()
        res["serve"] = dict(arch=name, batch=B, prompt=P, new=new, layers=base.n_layers,
                            experts=base.n_experts, **serve)
        res["replicated_ops"] = dict(REPLICATED)
        print("MESH " + json.dumps(res), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def run_mesh_child(seed: int, reduced: bool, timeout: float):
    """``--mesh-child`` in a fresh process (no process group outlives it
    here); its ``MESH`` record."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--mesh-child", "--seed", str(seed)]
    if reduced:
        cmd.append("--reduced")
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("MESH ")]
    require(out.returncode == 0 and len(lines) == 1,
            f"the [mesh] child failed (rc {out.returncode}): {out.stderr[-3000:]}")
    return json.loads(lines[0][5:])


def check_mesh(res):
    """The [mesh] record's checks; returns the lines to print."""
    t, s = res["train"], res["serve"]
    require(all(math.isfinite(v) for v in t["losses_plain"] + t["losses_policy"]),
            "a [mesh] training loss is not finite")
    require(t["loss_rel"] <= MESH_LOSS_TOL,
            f"[mesh] losses with and without the policy {t['loss_rel']:.3g} apart (relative)")
    require(t["param_gap"] <= MESH_PARAM_TOL and t["param_share"] <= MESH_PARAM_SHARE,
            f"[mesh] parameters with and without the policy: max gap {t['param_gap']:.3g}, "
            f"{t['param_share']:.3g} of the elements over 1e-6")
    require(s["gspmd"]["tokens"] == s["ep_shard_map"]["tokens"],
            "[mesh] the EP path's greedy tokens differ from the gspmd path's")
    return t, s


def phase_mesh(seed, smi):
    """[mesh] the policy on a world-size-1 NCCL mesh (a child process), then
    the dry-run cells started after the build."""
    t_phase = time.perf_counter()
    res = run_mesh_child(seed, False, MESH_BUDGET_S + 60)
    t, s = check_mesh(res)
    child_s = time.perf_counter() - t_phase
    say("mesh", f"{t['arch']} ({t['layers']} layers, fp32 compute, TF32 off), batch "
        f"{t['batch']}, seq {t['seq']}, AdamW lr {MESH_LR:g}, 2 steps each way on a 1x1 ('data', "
        "'model') NCCL mesh: losses "
        f"{t['losses_plain']} without the policy, {t['losses_policy']} with (max gap "
        f"{t['loss_rel']:.3g} relative, tol {MESH_LOSS_TOL:g}); parameters max |delta| "
        f"{t['param_gap']:.3g} (tol {MESH_PARAM_TOL:g}), {t['param_share']:.3g} of elements over "
        f"1e-6 (tol {MESH_PARAM_SHARE:g}); ms a step (the second; the first warms up) "
        f"{t['ms_plain'][-1]:.1f} without, {t['ms_policy'][-1]:.1f} with the policy "
        f"(DTensor's host cost {t['ms_policy'][-1] - t['ms_plain'][-1]:.1f} ms); {smi}")
    g, e = s["gspmd"], s["ep_shard_map"]
    say("mesh", f"{s['arch']} ({s['layers']} layers, {s['experts']} experts), batch {s['batch']}, "
        f"prompt {s['prompt']}, a prefill and {s['new']} greedy decode steps: "
        "moe_impl='ep_shard_map' under the policy "
        f"gives gspmd's tokens without one: {g['tokens'] == e['tokens']}; prefill "
        f"{g['prefill_ms']:.1f} / {e['prefill_ms']:.1f} ms, decode {np.median(g['decode_ms']):.1f} / "
        f"{np.median(e['decode_ms']):.1f} ms a step (median, host clock to a sync), without / "
        f"with the policy; replicated ops {res['replicated_ops']}; child process "
        f"{child_s:.1f} s; {smi}")
    for (arch, shape), (proc, t0, path) in DRY.items():
        try:
            _, err = proc.communicate(timeout=max(5.0, MESH_BUDGET_S - (time.perf_counter() - t_phase)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            require(False, f"the dry run of {arch} {shape} did not finish in time")
        require(proc.returncode == 0, f"the dry run of {arch} {shape} failed: {err[-3000:]}")
        rec = json.loads(path.read_text())
        require(rec["allocated_bytes"] == 0, f"the dry run of {arch} {shape} allocated")
        coll = ", ".join(f"{k} {rec['collective_counts'][k]} x / {v / 1e9:.3f} GB"
                         for k, v in rec["collective_by_kind"].items())
        say("mesh", f"dry run {arch} {shape} on a fake 16x16 process group ({rec['chips']} ranks, "
            f"meta shards, nothing allocated; host only, no card): step {rec['step_s']} s, set-up "
            f"{rec['setup_s']} s, started {t0 - T_START:.1f} s into the script; per device: params "
            f"{rec['param_bytes'] / 2**30:.4f} GiB, optimizer {rec['opt_bytes'] / 2**30:.4f} GiB, "
            f"cache {rec['cache_bytes'] / 2**30:.4f} GiB, inputs {rec['input_bytes'] / 2**20:.3f} "
            f"MiB; {rec['flops_per_device']:.4g} FLOPs, {rec['op_bytes_per_device']:.4g} B moved "
            f"unfused; collectives {coll}; roofline (H100 data sheet) {rec['roofline']}, dominant "
            f"{rec['dominant']}; useful FLOPs ratio {rec['useful_flops_ratio']:.4g}; replicated "
            f"ops {rec['replicated_ops']}")
    say("mesh", f"phase {time.perf_counter() - t_phase:.1f} s")


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
    v, refrac, i_tot, act, w16 = inputs
    red16 = panel_reduce(w16)
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
        t = dict(ms=0.0, ms_no_row_len=0.0, ms_bitmask_l2=0.0, library_ms=0.0, ms_bf16=0.0)
        real = active = moved = 0
        for b, (c, w, rl, csr) in enumerate(zip(cols, weights, row_len, csrs)):
            rb = red[b:b + 1]
            t["ms_bf16"] += cuda_ms(lambda c=c, w=w16[b], rl=rl, rb=red16[b:b + 1]:
                                    gather_mod.spike_gather_cuda(a, c, w, rl, reduce=rb), 20)
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
        # each launch reads the activity and row_len and writes R currents;
        # a bf16 weight is 2 bytes
        nb = 4 * (real + active) + nd * (4 * n_p + 8 * R)
        t["bound_ms"], t["bound_by"] = bound_ms(nb, 2 * active)
        t["bound_ms_bf16"], _ = bound_ms(nb - 2 * active, 2 * active)
        t.update(real=real, active=active, moved=moved, bytes=nb)
        gathers[label] = t
        say("timing", f"spike_gather, both buckets, {label} ({int(a.sum())} of {n_p} ids): "
            f"kernel {t['ms']:.4f} ms; whole rows (no row_len) {t['ms_no_row_len']:.4f} ms; "
            f"bitmask in device memory {t['ms_bitmask_l2']:.4f} ms; torch.sparse.mm "
            f"{t['library_ms']:.4f} ms; moves about {moved / 1e9:.4f} GB ({real} real slots' "
            f"cols and one sector per 8 slots holding an active one, in 32-byte sectors: "
            f"{moved / t['ms'] / 1e6:.0f} GB/s); bound {t['bound_ms']:.4f} ms ({t['bound_by']}: "
            f"{nb / 1e9:.4f} GB = 4 B x {real} real slots' cols + 4 B x {active} active "
            "slots' weights + activity, row_len and currents); bf16 weights: kernel "
            f"{t['ms_bf16']:.4f} ms, bound {t['bound_ms_bf16']:.4f} ms (2 B an active weight)")
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
    tk16 = cuda_ms(lambda: fused_mod.fused_step_cuda(fv, fr, fi, cols, w16, row_len,
                                                     params=params, reduce=red16), 20)
    b16, _ = bound_ms(f_bytes - 2 * f_active, 10 * n_p + 2 * f_active)
    b16_pad, _ = bound_ms(lif_bytes + panel_bytes * 6 // 8 + nd * R * 4,
                          10 * n_p + sum(2 * c.numel() for c in cols))
    tp = cuda_ms(lambda: ref.fused_step_ref(fv, fr, fi, cols, weights, params=params), 5)
    fs2 = fs[:, None].contiguous()
    f_lib = sum(cuda_ms(lambda csr=csr: torch.sparse.mm(csr, fs2), 20) for csr in csrs)
    say("timing", f"fused_step ({nd} buckets), the main path's step {ses.t} ({int(fs.sum())} "
        f"spikes): kernel {tk:.4f} ms (moves about {(f_moved + f_state) / 1e9:.4f} GB: "
        f"{(f_moved + f_state) / tk / 1e6:.0f} GB/s); its row_dot variant {tk_dot:.4f} ms; "
        f"plain {tp:.3f} ms; torch.sparse.mm over both buckets on the same spikes {f_lib:.4f} "
        f"ms; bound {b:.4f} ms ({by}: {f_bytes / 1e9:.4f} GB = 4 B x {f_real} real slots' cols "
        f"+ 4 B x {f_active} active slots' weights + state, bitmask, row_len and currents); "
        f"padded bound {b_pad:.4f} ms (every slot's col and weight); bf16 weights: kernel "
        f"{tk16:.4f} ms, bound {b16:.4f} ms, padded {b16_pad:.4f} ms (6 B a slot)")
    out.append(dict(name="fused_step", ms=tk, plain_ms=tp, bound_ms=b, bound_by=by,
                    library_ms=f_lib, ms_row_dot=tk_dot, bound_ms_padded=b_pad,
                    ms_bf16=tk16, bound_ms_bf16=b16, bound_ms_bf16_padded=b16_pad,
                    max_abs_err_bf16=errs["fused_step_bf16"],
                    vector=f"the main path's step {ses.t}: {int(fs.sum())} spikes"))
    del csrs
    g_p = sum(cuda_ms(lambda c=c, w=w: ref.spike_gather_ref(act, c, w), 5)
              for c, w in zip(cols, weights))
    g5, gm = gathers["5% active"], gathers["main-path step"]
    g_pad, _ = bound_ms(panel_bytes + nd * (4 * n_p + 4 * R), 2 * sum(c.numel() for c in cols))
    g_real, _ = bound_ms(8 * real_syn + nd * (4 * n_p + 4 * R), 2 * real_syn)
    g_pad16, _ = bound_ms(panel_bytes * 6 // 8 + nd * (4 * n_p + 4 * R),
                          2 * sum(c.numel() for c in cols))
    say("timing", f"spike_gather plain version (5% active) {g_p:.3f} ms; earlier bounds: "
        f"{g_pad:.4f} ms padded ELL ({panel_bytes / 1e9:.3f} GB; bf16 weights {g_pad16:.4f} ms, "
        f"6 B a slot), {g_real:.4f} ms every real synapse's col and weight")
    out.append(dict(name="spike_gather", ms=g5["ms"], plain_ms=g_p, bound_ms=g5["bound_ms"],
                    bound_by=g5["bound_by"], library_ms=g5["library_ms"],
                    bound_ms_real_synapses=g_real, bound_ms_padded_ell=g_pad,
                    ms_no_row_len=g5["ms_no_row_len"], ms_bitmask_l2=g5["ms_bitmask_l2"],
                    ms_main_path=gm["ms"], library_ms_main_path=gm["library_ms"],
                    bound_ms_main_path=gm["bound_ms"],
                    ms_main_path_bitmask_l2=gm["ms_bitmask_l2"],
                    ms_bf16=g5["ms_bf16"], bound_ms_bf16=g5["bound_ms_bf16"],
                    ms_bf16_main_path=gm["ms_bf16"], bound_ms_bf16_main_path=gm["bound_ms_bf16"],
                    bound_ms_bf16_padded_ell=g_pad16, max_abs_err_bf16=errs["spike_gather_bf16"],
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
        # timed as the engines launch it: the step t on the card, the slots
        # from t and the delays
        t_dev = torch.tensor(STEPS, device=sim.device)
        t = dict(
            ms=cuda_ms(lambda: event_mod.event_post_exchange_cuda(
                a, ring, t_dev, sim.dev.delays, plan, cols, weights, row_len, reduce=red), 20),
            ms_bitmask_l2=cuda_ms(lambda: event_mod.event_post_exchange_cuda(
                a, ring, t_dev, sim.dev.delays, plan, cols, weights, row_len, reduce=red,
                shared_bitmask=False), 20),
            ms_bf16=cuda_ms(lambda: event_mod.event_post_exchange_cuda(
                a, ring, t_dev, sim.dev.delays, plan, cols, w16, row_len, reduce=red16), 20),
        )
        t["bound_ms"], t["bound_by"] = bound_ms(e_bytes, 2 * active)
        t["bound_ms_bf16"], _ = bound_ms(e_bytes - 2 * active, 2 * active)
        events[label] = t
        say("timing", f"event_post_exchange, {label} ({n_ids} spikes, {rows} of {nd * n_p} "
            f"(bucket, row) pairs in flagged blocks): kernel {t['ms']:.4f} ms, bitmask in L2 "
            f"{t['ms_bitmask_l2']:.4f} ms; torch.sparse.mm over both buckets "
            f"{gathers[label]['library_ms']:.4f} ms; moves about {moved / 1e9:.4f} GB of panel "
            f"({moved / t['ms'] / 1e6:.0f} GB/s); bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}: {e_bytes / 1e9:.4f} GB = 4 B x {real} real slots' cols + 4 B x "
            f"{active} active slots' weights + activity, ring, row_len, ids and touch bytes); "
            f"bf16 weights: kernel {t['ms_bf16']:.4f} ms, bound {t['bound_ms_bf16']:.4f} ms")
    em, e5 = events["main-path step"], events["5% active"]
    ring, _, _ = event_case(sim)
    t_dev = torch.tensor(STEPS, device=sim.device)
    tp = cuda_ms(lambda: event_mod.event_post_exchange_plain(eact, ring, t_dev, sim.dev.delays,
                                                             plan, cols, weights), 5)
    say("timing", f"event_post_exchange plain version (main-path step) {tp:.3f} ms")
    out.append(dict(name="event_post_exchange", ms=em["ms"], plain_ms=tp, bound_ms=em["bound_ms"],
                    bound_by=em["bound_by"], library_ms=gm["library_ms"],
                    ms_bitmask_l2=em["ms_bitmask_l2"], ms_5pct=e5["ms"],
                    bound_ms_5pct=e5["bound_ms"], library_ms_5pct=g5["library_ms"],
                    ms_bf16=em["ms_bf16"], bound_ms_bf16=em["bound_ms_bf16"],
                    ms_bf16_5pct=e5["ms_bf16"], bound_ms_bf16_5pct=e5["bound_ms_bf16"],
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
    for mode in ("dense", "event"):  # capture each key first: the timed runs replay
        sim.set_gather(mode)
        sim.run(ses.state, ENGINE_STEPS)
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
    other operands, runs first in the same session, and only the kernels
    after a marker (``torch.cuda._sleep``'s spin kernel) launched between the
    two are counted: without the warm-up, a trace of one k>1 Brunel step
    missed launches (2 of its 4 step fronts).  One session and no schedule:
    with a warm-up step in a schedule, traces on the card came back empty,
    once three times in a row."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            warm()
            torch.cuda.synchronize()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    marks = [e.time_range.end for e in device if "spin" in e.name]
    if not marks:
        return Counter()
    return Counter(e.name for e in device if e.time_range.start >= marks[-1])


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
            # the plastic kernels update the carry's weights in place
            carry["weights"] = tuple(w.clone() for w in c["weights"])
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


# -- the compiled chunk: one CUDA graph per engine, chunk length and recordings

# per path the us/step graphed and uncaptured (phase_graph), for the summary
GRAPH_US = {}
# paths whose idle share phase_idle measures after their net's timed runs:
# (tag, simulator, start state, gather mode)
IDLE_PENDING = []


def idle_share(fn):
    """``(idle share, device events, window ms)`` of the card over ``fn``,
    on the device's clock: the window is ``fn``'s span between two CUDA
    events recorded around it (a run without the profiler, whose per-launch
    cost would stretch an uncaptured window), the busy time the union of
    the device's kernel, copy and memset intervals that ``torch.profiler``
    traced in another run of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm: a capture or the library load stays out of both runs
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    window_us = start.elapsed_time(stop) * 1e3
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, reach = 0.0, -math.inf
    for lo, hi in spans:
        lo = max(lo, reach)
        if hi > lo:
            busy += hi - lo
            reach = hi
    return max(0.0, 1.0 - busy / max(window_us, 1e-9)), len(spans), window_us / 1e3


def carries_of(state):
    return [state] if isinstance(state, dict) else list(state)


def require_states_bit_equal(a, b, what):
    for p, (ca, cb) in enumerate(zip(carries_of(a), carries_of(b))):
        require(torch.equal(ca["t"], cb["t"]), f"{what}: partition {p} t differs")
        for key in ("vtx_state", "ring", "hist", "tr_plus", "tr_minus"):
            require_same_bits(ca[key], cb[key], f"{what}: partition {p} {key}")
        for wa, wb in zip(ca["weights"], cb["weights"]):
            require_same_bits(wa, wb, f"{what}: partition {p} weights")


def require_no_host_sync(sim, state, steps=16):
    """One uncaptured chunk under ``torch.cuda.set_sync_debug_mode("error")``:
    no op of a step reads back to the host."""
    with uncaptured(sim):
        sim.run(state, 2, record_raster=True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            sim.run(state, steps, record_raster=True, record_v=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def phase_graph(tag, ses, st0, gather0, steps, raster, after=None, measure=True,
                order=(True, False), max_kernels=None, **run):
    """[graph] The path's ``steps`` steps from its start state ``st0``
    (gather mode ``gather0``), graphed and uncaptured in turns (by default
    graphed, then uncaptured: one run each way), each raster equal to the path's and
    the end states bit-equal; the captured keys' set-up seconds and their
    graphs' nodes by kind; one uncaptured chunk with no host sync; and the
    path queued for ``phase_idle`` (``measure=False`` skips these three).
    ``run`` goes to ``ses.run``, ``after()`` runs after each timed run, and
    ``order`` says which runs are graphed; ``max_kernels`` bounds each
    captured key's kernel nodes a step.  Returns the us/step of both
    (lists)."""
    sim = ses.simulator
    per, ends = {True: [], False: []}, {}
    for graphed in order:
        ses._state = st0
        sim.set_gather(gather0)
        with contextlib.nullcontext() if graphed else uncaptured(sim):
            require(sim.graph_mode == ("cuda_graph" if graphed else "uncaptured: _graphs=False"),
                    f"{tag}: graph mode {sim.graph_mode}")
            mon = RasterMonitor()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ses.run(steps, monitors=[mon], **run)
            torch.cuda.synchronize()
            per[graphed].append((time.perf_counter() - t0) / steps * 1e6)
        if after is not None:
            after()
        require(np.array_equal(mon.raster, raster),
                f"{tag}: the {'graphed' if graphed else 'uncaptured'} raster differs from the path's")
        ends.setdefault(graphed, ses.state)
    require_states_bit_equal(ends[True], ends[False], f"{tag}: graphed vs uncaptured end state")
    graphed, bare = (" and ".join(f"{x:.1f}" for x in per[g]) for g in (True, False))
    say("graph", f"{tag}: {steps} steps from the path's start state, us/step graphed "
        f"{graphed}, uncaptured (_graphs=False) {bare} (host clock, a "
        f"RasterMonitor, in the order {', '.join('graphed' if g else 'uncaptured' for g in order)}"
        "); rasters identical "
        "to the path's, end states bit-equal (t, vtx_state, ring, hist, traces, weights)")
    GRAPH_US[tag] = per
    if not measure:
        return per
    for g in sim._graphs.graphs.values():
        kinds = graph_node_kinds(g.graph)
        say("graph", f"{tag}: key {g.what}: warm-up {g.warmup_s:.3f} s, capture {g.capture_s:.3f} "
            f"s, instantiate {g.instantiate_s:.3f} s, {g.replays} replays; nodes "
            + ", ".join(f"{k} {v}" for k, v in sorted(kinds.items()))
            + f"; {kinds['kernel'] / g.steps:.2f} kernels a step")
        require(kinds["memcpy_to_host"] == 0, f"{tag}: a memcpy to the host in {g.what}")
        # the chunk adds one kernel of its own (its outputs) to its steps'
        require(max_kernels is None or kinds["kernel"] <= max_kernels * g.steps + 1,
                f"{tag}: {g.what} runs more than {max_kernels} kernels a step "
                f"({kinds['kernel']} kernel nodes for {g.steps} steps)")
    require_no_host_sync(sim, st0)
    say("graph", f"{tag}: an uncaptured chunk of {sim.engine_choice.engine} under "
        "torch.cuda.set_sync_debug_mode('error'): no host sync")
    IDLE_PENDING.append((tag, sim, st0, sim.gather))
    return per


def phase_idle():
    """[graph] The idle share of the card over one graphed and one
    uncaptured chunk of each path that ``phase_graph`` ran since the last
    call, from its start state on its last engine.  Called after the timed
    runs of the paths' net: a ``torch.profiler`` session slows the host
    side of the runs after it."""
    while IDLE_PENDING:
        tag, sim, st0, gather = IDLE_PENDING.pop(0)
        mode0 = sim.gather
        sim.set_gather(gather)
        engine, c = sim.engine_choice.engine, _DEFAULT_CHUNK
        idle_g, n_g, ms_g = idle_share(lambda: sim.run(st0, c, record_raster=True))
        with uncaptured(sim):
            idle_u, n_u, ms_u = idle_share(lambda: sim.run(st0, c, record_raster=True))
        sim.set_gather(mode0)
        say("graph", f"{tag}: idle share of the card over one {c}-step chunk of {engine} (busy: "
            "the union of the device intervals torch.profiler traced; window: CUDA events "
            f"around an unprofiled run): graphed {idle_g:.4f} ({n_g} device events, window "
            f"{ms_g:.3f} ms), uncaptured {idle_u:.4f} ({n_u}, {ms_u:.3f} ms)")


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
    # timed as the engines launch it: the step t on the card
    t_dev = torch.tensor(STEPS, device=card)
    tk = cuda_ms(lambda: noise_mod.noise_add_cuda(ring[3], ids_m, seed, t_dev, sigma, bias), 200)
    tp = cuda_ms(lambda: ref.step_noise_add_ref(ring[3], ids_m, seed, t_dev, sigma, bias), 10)
    chain = dict(
        clone=cuda_ms(lambda: ring[3].clone(), 200),
        noise=cuda_ms(lambda: noise_mod.noise_add_cuda(neg0, all_ids, seed, t_dev, sigma), 200),
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
    t = int(carry["t"])
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
    t = torch.tensor(int(t), device=vtx.device)  # as the engines pass it: on the card
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
    # bf16 weights (the reference kernel's bf16 rule; the engines keep f32
    # panels): the same panels cast to bf16, with a bf16 and an f32 mask
    changed16 = 0
    for c, w, pm, d in zip(cols, weights, plastic, sim.dev.delays):
        w16 = w.bfloat16()
        for m in (pm.bfloat16(), pm):
            got = stdp_mod.stdp_update_cuda(w16, m, c, *stdp_args, params=stdp)
            require(got.dtype == torch.bfloat16 and torch.equal(
                got, stdp_mod.stdp_update_plain(w16, m, c, *stdp_args, params=stdp)),
                f"stdp_update on bf16 weights ({m.dtype} mask, d={d}) differs from its plain "
                "version")
            inplace = w16.clone()
            stdp_mod.stdp_update_cuda(inplace, m, c, *stdp_args, params=stdp, out=inplace)
            require(torch.equal(inplace, got), f"stdp_update on bf16 weights in place (d={d})")
        changed16 += int((got != w16).sum())
    require(changed16 > 0, "stdp_update on bf16 weights changed no weight")
    say("plastic", f"stdp_update on the {len(cols)} panels cast to bf16, bf16 and f32 masks: "
        f"bit-exact vs plain (every op rounded to bf16), in place and out of place "
        f"({changed16} slots change)")

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

    # the main path's form: the real slots only (row_len), the currents
    # added into the ring in the launch, the weights in place
    row_len, D, delays = sim.dev.row_len, sim.d_ring, sim.dev.delays
    t_step = 7
    ring0 = torch.from_numpy(rng.normal(size=(D, n_p)).astype(np.float32)).to(dev)
    ring0[:, : n_p // 4] = -0.0  # signed zeros: rows with no input keep -0 + +0 = +0
    want_ring = ring0.clone()
    for cur, d in zip(out[5], delays):
        want_ring.index_add_(0, torch.tensor([(t_step + d) % D], device=dev), cur[:n_p][None])
    ring = ring0.clone()
    work = [w.clone() for w in weights]
    t_dev = torch.tensor(t_step, dtype=torch.int64, device=dev)
    got = fused_mod.fused_step_plastic_cuda(v, refrac, i_tot, tp, tm, cols, work, plastic,
                                            row_len, params=params, taus=taus, stdp=stdp,
                                            ring=ring, t=t_dev, delays=delays, weights_out=work)
    require(got[5] is ring and same_bits(ring, want_ring),
            "fused_step_plastic's ring add differs from index_add_ of its currents")
    require(all(same_bits(a, b) for a, b in zip(got[:5], out[:5])) and all(
        same_bits(a, b) for a, b in zip(work, out[6])),
        "fused_step_plastic over the real slots, in place, differs from every slot, out of place")
    written = sum(int((a.view(torch.int32) != b.view(torch.int32))[pm == 0].sum())
                  for a, b, pm in zip(work, weights, plastic))
    require(written == 0, "fused_step_plastic wrote a padding or non-plastic slot")
    plain_ring = ring0.clone()
    plain_w = [w.clone() for w in weights]
    fused_mod.fused_step_plastic_plain(v, refrac, i_tot, tp, tm, cols, plain_w, plastic, row_len,
                                       params=params, taus=taus, stdp=stdp, ring=plain_ring,
                                       t=t_dev, delays=delays, weights_out=plain_w)
    require(all(same_bits(a, b) for a, b in zip(work, plain_w)),
            "fused_step_plastic's ring form: weights differ from its plain version")
    torch.testing.assert_close(ring, plain_ring, rtol=1e-5, atol=1e-5)
    real = sum(int(rl.sum()) for rl in row_len)
    say("plastic", f"fused_step_plastic as the engine runs it ({real} real slots of "
        f"{sum(c.numel() for c in cols)}, ring t={t_step}, weights in place): ring bit-exact vs "
        "index_add_ of the currents (signed zeros too), the rest bit-exact vs every slot out "
        "of place, no padding or non-plastic slot written; vs its plain version weights "
        "bit-exact, ring within rtol=atol=1e-5")
    inputs = dict(v=v, refrac=refrac, i_tot=i_tot, tp=tp, tm=tm, stdp_args=stdp_args,
                  step_args=(tp1, s1, tm1, s1))
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
                             stdp_update=PARITY_STEPS, noise_add=PARITY_STEPS),
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


def plastic_slot_bytes(cols, plastic, row_len, act):
    """The slot bytes a one-pass plastic kernel must move over its buckets'
    real slots (``row_len``): col and mask (8 B) at every real slot, the
    weight read and written (8 B) at a plastic one, and a non-plastic
    slot's weight (4 B) only where the gather's ``act[col]`` is not 0, as a
    gather's weight is counted (row 2b).  Also the earlier yardstick, 16 B
    at every real slot, and the counts: (bytes, bytes at 16 B a real slot,
    real, plastic, active non-plastic)."""
    real = plastic_real = active = 0
    for c, pm, rl in zip(cols, plastic, row_len):
        is_real = torch.arange(c.shape[1], device=c.device)[None, :] < rl[:, None]
        is_plastic = (pm > 0) & is_real
        real += int(is_real.sum())
        plastic_real += int(is_plastic.sum())
        active += int((is_real & ~is_plastic & (act[c.long()] != 0)).sum())
    return 8 * real + 8 * plastic_real + 4 * active, 16 * real, real, plastic_real, active


def stdp_step_figures(tag, dev, pre_t, pre_s, post_t, post_s, stdp):
    """``stdp_update_step`` (row 10, one launch a step) on a partition's
    panels: its weights bit-equal to its plain version and to the
    per-panel kernel a bucket (the old loop, post terms padded or taken
    through the row map), one launch a group, no masked-off slot written;
    then timed in turns with the old loop (both in place on copies), and
    the plain version.  The bound counts what these inputs need: the mask
    at each real slot of a row that holds a plastic slot (the rows the
    plan lists: a row without one needs nothing), col and weight at each
    plastic real slot, 4 B written at each slot whose bits change (counted
    on these inputs), the plan's 16 B item a listed row, the four vectors;
    the yardsticks: the mask at every real slot with ``row_len`` a row and
    ``row_map`` a split row (the form the plan replaced), col and mask at
    every real slot and the plastic weight read and written (rows 4/7/8's,
    less their non-plastic weight term), and 16 B at every slot."""
    plan = dev.stdp_plan
    cols, w0, masks = dev.cols, dev.weights0, dev.plastic
    padded = [tuple(x.index_select(0, rm) if rm is not None else
                    torch.nn.functional.pad(x, (0, c.shape[0] - dev.n_p)) for x in (post_t, post_s))
              for c, rm in zip(cols, plan.row_map)]
    old = [stdp_mod.stdp_update_cuda(w, m, c, pre_t, pre_s, *pp, params=stdp)
           for w, m, c, pp in zip(w0, masks, cols, padded)]
    work = [w.clone() for w in w0]
    before = stdp_mod.COUNTER.launches
    stdp_mod.stdp_update_step_cuda(work, masks, cols, pre_t, pre_s, post_t, post_s, plan=plan,
                                   params=stdp)
    torch.cuda.synchronize()
    groups = sum(hi > lo for lo, hi in plan.groups)
    require(stdp_mod.COUNTER.launches == before + groups == before + 1,
            f"{tag}: stdp_update_step made {stdp_mod.COUNTER.launches - before} launches")
    plain = stdp_mod.stdp_update_step_plain([w.clone() for w in w0], masks, cols, pre_t, pre_s,
                                            post_t, post_s, plan=plan, params=stdp)
    for b, (x, y, z) in enumerate(zip(work, old, plain)):
        require(same_bits(x, y), f"{tag}: stdp_update_step differs from the per-panel kernel "
                f"(bucket {b})")
        require(same_bits(x, z), f"{tag}: stdp_update_step differs from its plain version "
                f"(bucket {b})")
    writes = sum(int((x.view(torch.int32) != w.view(torch.int32)).sum())
                 for x, w in zip(work, w0))
    require(writes > 0, f"{tag}: stdp_update_step changed no weight")
    real = plastic_real = slots = rows = split_rows = 0
    for c, m, rl, rm in zip(cols, masks, dev.row_len, plan.row_map):
        is_real = torch.arange(c.shape[1], device=c.device)[None, :] < rl[:, None]
        real += int(is_real.sum())
        plastic_real += int(((m > 0) & is_real).sum())
        slots += c.numel()
        rows += c.shape[0]
        split_rows += 0 if rm is None else c.shape[0]
    vec_b = 4 * (pre_t.numel() + pre_s.numel() + post_t.numel() + post_s.numel())
    items = int(plan.items.shape[0])
    listed_real = int(plan.items[:, 2].sum())  # the listed rows' real slots
    nb = 4 * listed_real + 8 * plastic_real + 4 * writes + 16 * items + vec_b
    ops_ = 8 * plastic_real
    f = dict(launches_a_step=groups, real_slots=real, listed_real_slots=listed_real,
             plastic_slots=plastic_real, writes=writes, items=items, rows=rows, gb=nb / 1e9)
    f["bound_ms"], f["bound_by"] = bound_ms(nb, ops_)
    f["bound_ms_all_rows"] = bound_ms(4 * real + 8 * plastic_real + 4 * writes + 4 * rows
                                      + 4 * split_rows + vec_b, ops_)[0]
    f["bound_ms_rows_4_7_8"] = bound_ms(8 * real + 8 * plastic_real + 4 * rows
                                        + 4 * split_rows + vec_b, ops_)[0]
    f["bound_ms_every_slot"] = bound_ms(16 * slots + vec_b, 8 * slots)[0]
    old_w = [w.clone() for w in w0]
    times = {"ms": [], "old_ms": []}
    for key in ("ms", "old_ms", "old_ms", "ms"):
        if key == "ms":
            times[key].append(cuda_ms(lambda: stdp_mod.stdp_update_step_cuda(
                work, masks, cols, pre_t, pre_s, post_t, post_s, plan=plan, params=stdp), 50))
        else:
            times[key].append(cuda_ms(lambda: [stdp_mod.stdp_update_cuda(
                w, m, c, pre_t, pre_s, *pp, params=stdp, out=w)
                for w, m, c, pp in zip(old_w, masks, cols, padded)], 20))
    f.update({k: min(v) for k, v in times.items()})
    f["runs_ms"] = times
    f["plain_ms"] = cuda_ms(lambda: stdp_mod.stdp_update_step_plain(
        old_w, masks, cols, pre_t, pre_s, post_t, post_s, plan=plan, params=stdp), 3)
    say("timing" if tag == "plastic" else "maxk",
        f"{tag}: stdp_update_step over the {len(cols)} buckets ({items} rows with a plastic "
        f"slot of {rows}; {real} real slots of {slots}, {listed_real} in the listed rows, "
        f"{plastic_real} plastic, "
        f"{writes} written on these inputs; in place): bit-equal to its plain version and to "
        f"the per-panel kernel a bucket; {groups} launch: kernel {f['ms']:.4f} ms ("
        f"{', '.join(f'{x:.4f}' for x in times['ms'])}; {nb / f['ms'] / 1e6:.0f} GB/s of the "
        f"bound's traffic), the old loop of {len(cols)} per-panel launches {f['old_ms']:.4f} ms "
        f"({', '.join(f'{x:.4f}' for x in times['old_ms'])}), plain {f['plain_ms']:.3f} ms; "
        f"bound {f['bound_ms']:.4f} ms ({f['bound_by']}: {nb / 1e9:.4f} GB): "
        f"{f['bound_ms'] / f['ms']:.0%}; every real row's mask, row_len and row_map "
        f"[{f['bound_ms_all_rows']:.4f} ms: {f['bound_ms_all_rows'] / f['ms']:.0%}]; "
        f"rows 4/7/8's yardstick [{f['bound_ms_rows_4_7_8']:.4f} "
        f"ms: {f['bound_ms_rows_4_7_8'] / f['ms']:.0%}]; every slot "
        f"[{f['bound_ms_every_slot']:.4f} ms: {f['bound_ms_every_slot'] / f['ms']:.0%}]")
    return f


def phase_plastic_timing(sim, params, inputs, errs, launches):
    v, refrac, i_tot, tp, tm = (inputs[k] for k in ("v", "refrac", "i_tot", "tp", "tm"))
    stdp_args = inputs["stdp_args"]
    n_p = sim.dev.n_p
    cols, weights, plastic = sim.dev.cols, sim.dev.weights0, sim.dev.plastic
    stdp, taus = sim.stdp_params, stdp_taus(sim)
    nd, R = len(cols), cols[0].shape[0]
    slots = sum(c.numel() for c in cols)
    out = []

    # the engine form, one launch a step, beside the old loop of per-panel
    # launches on the same inputs
    f = stdp_step_figures("plastic", sim.dev, *inputs["step_args"], stdp)
    real = f["real_slots"]
    # bf16 weights: 10 B a slot with a bf16 mask (col 4, weight 2 read and 2
    # written, mask 2), 12 B with an f32 mask
    b16 = dict(ms_bf16=0.0, ms_bf16_f32_mask=0.0, plain_ms_bf16=0.0, bound_ms_bf16=0.0,
               bound_ms_bf16_f32_mask=0.0)
    for c, w, pm in zip(cols, weights, plastic):
        w16, pm16 = w.bfloat16(), pm.bfloat16()
        b16["ms_bf16"] += cuda_ms(lambda c=c, w=w16, pm=pm16: stdp_mod.stdp_update_cuda(
            w, pm, c, *stdp_args, params=stdp), 50)
        b16["ms_bf16_f32_mask"] += cuda_ms(lambda c=c, w=w16, pm=pm: stdp_mod.stdp_update_cuda(
            w, pm, c, *stdp_args, params=stdp), 50)
        b16["plain_ms_bf16"] += cuda_ms(lambda c=c, w=w16, pm=pm16: stdp_mod.stdp_update_plain(
            w, pm, c, *stdp_args, params=stdp), 5)
        vec_b = 2 * n_p * 4 + 2 * R * 4
        b16["bound_ms_bf16"] += bound_ms(c.numel() * 10 + vec_b, 6 * c.numel())[0]
        b16["bound_ms_bf16_f32_mask"] += bound_ms(c.numel() * 12 + vec_b, 6 * c.numel())[0]
    say("timing", f"stdp_update on bf16 weights, {nd} launches (one step): bf16 mask "
        f"{b16['ms_bf16']:.4f} ms ({b16['ms_bf16'] / nd * 1e3:.2f} us a launch), bound "
        f"{b16['bound_ms_bf16']:.4f} ms (10 B a slot); f32 mask {b16['ms_bf16_f32_mask']:.4f} "
        f"ms, bound {b16['bound_ms_bf16_f32_mask']:.4f} ms (12 B a slot); plain "
        f"{b16['plain_ms_bf16']:.3f} ms")
    out.append(dict(name="stdp_update", library_ms=None, path="plastic_unfused",
                    max_abs_err_bf16=0.0, **{k: v for k, v in f.items() if k != "runs_ms"},
                    **b16))

    # as the engine launches it: the real slots, the ring add, the weights
    # in place (on copies of the panels and of a ring)
    kw = dict(params=params, taus=taus, stdp=stdp)
    D = sim.d_ring
    work = [w.clone() for w in weights]
    ring = torch.zeros((D, n_p), dtype=torch.float32, device=sim.device)
    t_dev = torch.zeros((), dtype=torch.int64, device=sim.device)
    ring_kw = dict(ring=ring, t=t_dev, delays=sim.dev.delays, weights_out=work)
    # the slots as plastic_slot_bytes counts them (the gather's activity
    # is this step's spikes), 4 B of row_len a row, the ten state and trace
    # vectors, the ring row read and written a row and bucket; 16 B a real
    # slot and every slot in brackets
    spikes = fused_mod.fused_step_plastic_cuda(
        v, refrac, i_tot, tp, tm, cols, work, plastic, sim.dev.row_len, **kw, **ring_kw)[2]
    slot_b, slot_16, _, n_pl, n_act = plastic_slot_bytes(cols, plastic, sim.dev.row_len, spikes)
    rest = nd * R * 4 + 10 * 4 * n_p + nd * n_p * 8
    f_bytes = slot_b + rest
    f_pad = slots * 16 + 10 * 4 * n_p + nd * R * 4
    f_flops = 14 * n_p + 8 * real
    tk = cuda_ms(lambda: fused_mod.fused_step_plastic_cuda(
        v, refrac, i_tot, tp, tm, cols, work, plastic, sim.dev.row_len, **kw, **ring_kw), 50)
    tp_ = cuda_ms(lambda: fused_mod.fused_step_plastic_plain(
        v, refrac, i_tot, tp, tm, cols, work, plastic, sim.dev.row_len, **kw, **ring_kw), 5)
    b, by = bound_ms(f_bytes, f_flops)
    b_16, _ = bound_ms(slot_16 + rest, f_flops)
    b_pad, _ = bound_ms(f_pad, 14 * n_p + 8 * slots)
    say("timing", f"fused_plastic_step ({nd} buckets, {real} real slots of {slots}, {n_pl} "
        f"plastic, {n_act} non-plastic under a spike; row_len, the ring add and the weights "
        f"in place): kernel {tk:.4f} ms ({f_bytes / tk / 1e6:.0f} GB/s of the bound's "
        f"traffic), plain {tp_:.3f} ms, bound {b:.4f} ms ({f_bytes / 1e9:.4f} GB): "
        f"{b / tk:.0%}; 16 B a real slot [{b_16:.4f} ms, {b_16 / tk:.0%}]; every slot "
        f"[{b_pad:.4f} ms, {f_pad / 1e9:.4f} GB]")
    out.append(dict(name="fused_plastic_step", ms=tk, plain_ms=tp_, bound_ms=b, bound_by=by,
                    library_ms=None, path="plastic", bound_ms_16b_a_real_slot=b_16,
                    bound_ms_every_slot=b_pad))
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
    for ses in (fused_ses, unfused_ses):  # capture each key first: the timed runs replay
        ses.simulator.run(state, ENGINE_STEPS)
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
        # bf16 panels: bit-equal to the same kernel on their f32 widening
        w16 = [w.to(torch.bfloat16) for w in weights]
        wide = [w.float() for w in w16]
        for rb in (panel_reduce(w16), "row_dot"):
            g16 = split_mod.post_exchange_cuda(a, ring, cl, onehot, cols, w16, row_len, reduce=rb)
            g32 = split_mod.post_exchange_cuda(a, ring, cl, onehot, cols, wide, row_len, reduce=rb)
            require(torch.equal(g16.view(torch.int32), g32.view(torch.int32)),
                    f"bf16 post_exchange {what} ({rb}) differs from its f32 widening")
        del w16, wide
        say("k4", f"post_exchange {what}, panels {[tuple(c.shape) for c in cols]}, row_len, "
            f"reduce {reduce}, {int(a.sum())} of {a.shape[0]} ids active, {n_active} slots "
            "with an active source: bit-exact (signed zeros too) vs its forced row_dot variant, vs "
            "the activity tested in device memory, vs spike_gather + ring formulation, and in "
            "place; bf16 panels bit-equal to their f32 widening (recorded reduce and row_dot); "
            f"max |kernel - plain| = {e:.3e} (rtol=atol=1e-5)")
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
        w16 = [w.to(torch.bfloat16) for w in dev.weights0]
        g16, g32 = ring.clone(), ring.clone()
        event_mod.event_post_exchange_cuda(a, g16, s, write, plan, dev.cols, w16, dev.row_len,
                                           reduce=panel_reduce(w16))
        event_mod.event_post_exchange_cuda(a, g32, s, write, plan, dev.cols,
                                           [w.float() for w in w16], dev.row_len,
                                           reduce=panel_reduce(w16))
        require(torch.equal(g16.view(torch.int32), g32.view(torch.int32)),
                f"bf16 split event ring differs from its f32 widening ({what})")
        del w16
        e = float((got - want).abs().max())
        e_err = max(e_err, e)
        say("k4", f"event_post_exchange split use, {what}: act ({a.shape[0]},) with "
            f"{int(a.sum())} spikes, ring {tuple(ring.shape)}, {float(flags.float().mean()):.4f} "
            f"of {flags.numel()} (bucket, block) pairs flagged; flags equal plain, ring "
            f"bit-equal to spike_gather's, to post_exchange's row_dot variant and, on bf16 "
            f"panels, to their f32 widening; max |kernel - plain| "
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


def _csr_rows(cols, weights, row_len, row_ptr, n):
    """A split panel's real slots as a CSR matrix of its real rows (row
    ``r`` holds the slots of virtual rows ``row_ptr[r]`` to ``row_ptr[r+1] -
    1``, in order), for ``torch.sparse.mm`` on the segmented gather's work."""
    R, K = cols.shape
    live = torch.arange(K, device=cols.device)[None, :] < row_len.long()[:, None]
    cum = torch.zeros(R + 1, dtype=torch.int64, device=cols.device)
    cum[1:] = torch.cumsum(row_len.long(), 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(cum.index_select(0, row_ptr.long()), cols[live].long(),
                                       weights[live], size=(row_ptr.shape[0] - 1, n),
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
        w16 = [w.to(torch.bfloat16) for w in weights]
        red16 = panel_reduce(w16)
        t16 = cuda_ms(lambda: split_mod.post_exchange_cuda(a, work, cl, onehot, cols, w16,
                                                           row_len, reduce=red16, out=work), 20)
        del w16
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
        b16, _ = bound_ms(nb - 2 * active, 2 * active)  # a bf16 weight is 2 bytes
        b_pad, _ = bound_ms(post_bytes(cols, a.shape[0], D, n_p), 2 * sum(c.numel() for c in cols))
        return dict(ms=tk, ms_row_dot=t_dot, ms_bf16=t16, bound_ms_bf16=b16, plain_ms=tp,
                    library_ms=lib_p, bound_ms=b,
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
            f"padded bound {x['bound_ms_padded']:.4f} ms; bf16 weights: kernel "
            f"{x['ms_bf16']:.4f} ms, bound {x['bound_ms_bf16']:.4f} ms")
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
                               "bound_ms_padded", "ms_bf16", "bound_ms_bf16")},
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
        # timed as the remote pass launches it: t on the card, no clear
        t_dev = torch.tensor(STEPS, device=card)
        t = dict(
            ms=cuda_ms(lambda: event_mod.event_post_exchange_cuda(
                a, work, t_dev, dev.delays, plan, dev.cols, dev.weights0, dev.row_len,
                reduce=dev.reduce, clear=False), 20),
            ms_bitmask_l2=cuda_ms(lambda: event_mod.event_post_exchange_cuda(
                a, work, t_dev, dev.delays, plan, dev.cols, dev.weights0, dev.row_len,
                reduce=dev.reduce, shared_bitmask=False, clear=False), 20),
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
    t_dev = torch.tensor(STEPS, device=card)
    tp = cuda_ms(lambda: event_mod.event_post_exchange_plain(act_remote, work, t_dev, dev.delays,
                                                             plan, dev.cols, dev.weights0,
                                                             clear=False), 5)
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
    for mode in ("dense", "event"):  # capture each key first: the timed runs replay
        dsim.set_gather(mode)
        dsim.run(ses.state, ENGINE_STEPS)
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
                    stdp_update=K_PARTS * steps, noise_add=K_PARTS * steps)
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
        # as the engine launches it: the real slots, the weights in place,
        # and for the remote pass the own slice zeroed in the kernel
        ring_e, work = ring.clone(), [w.clone() for w in weights]
        split_mod.post_exchange_plastic_cuda(
            act if cl is not None else None, act, pre, ring_e, cl, onehot, post_t, post_s, cols,
            work, plastic, dev.row_len, stdp=stdp, out=ring_e,
            own=None if cl is not None else (0, n_p), weights_out=work)
        require(same_bits(ring_e, new_ring) and all(same_bits(a, b) for a, b in zip(work, new_w)),
                f"{name} over the real slots, in place{'' if cl is not None else ', own slice'} "
                "differs from every slot, out of place")
        written = sum(int((a.view(torch.int32) != b.view(torch.int32))[pm == 0].sum())
                      for a, b, pm in zip(work, weights, plastic))
        require(written == 0, f"{name} wrote a padding or non-plastic slot")
        say("k4", f"{name}, {len(cols)} buckets of {tuple(cols[0].shape)}: ring bit-exact vs "
            "spike_gather + ring formulation, weights bit-exact vs plain and vs stdp_update "
            f"({changed} slots change); ring max |kernel - plain| = {errs[name]:.3e} "
            "(rtol=atol=1e-5); the engine's form (row_len, weights in place"
            f"{'' if cl is not None else ', own slice zeroed in the kernel'}) bit-equal, no "
            "padding or non-plastic slot written")
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
    # the slots as plastic_slot_bytes counts them (the remote pass's
    # gather reads the own slice as 0), 4 B of row_len a row, the three
    # global vectors, the post terms, the ring read and written; 16 B a
    # real slot and every slot (and no row_len) in brackets
    real = sum(int(rl.sum()) for rl in dev.row_len)
    rest = 3 * n * 4 + 2 * n_p * 4 + 2 * D * n_p * 4 + (nd + 1) * D * 4
    act_remote = x["act"].clone()
    act_remote[:n_p] = 0
    b_pad, _ = bound_ms(slots * 16 + rest, 10 * slots)
    # as the engine launches them: row_len, the weights in place (on copies
    # of the panels), the remote pass's own slice zeroed in the kernel
    work = x["ring"].clone()
    work_w = [w.clone() for w in weights]
    for name, a, cl in (("post_exchange_remote_plastic", None, None),
                        ("post_exchange_plastic", x["act"], x["clear"])):
        slot_b, slot_16, _, n_pl, n_act = plastic_slot_bytes(
            cols, plastic, dev.row_len, act_remote if a is None else a)
        nb = slot_b + nd * R * 4 + rest
        b, by = bound_ms(nb, 10 * real)
        b_16, _ = bound_ms(slot_16 + nd * R * 4 + rest, 10 * real)
        tk = cuda_ms(lambda a=a, cl=cl: split_mod.post_exchange_plastic_cuda(
            a, x["act"], x["pre"], work, cl, x["onehot"], x["post_t"], x["post_s"], cols,
            work_w, plastic, dev.row_len, stdp=stdp, out=work,
            own=(0, n_p) if a is None else None, weights_out=work_w), 50)
        if cl is None:
            tp = cuda_ms(lambda: ref.fused_post_exchange_remote_plastic_ref(
                None, x["act"], x["pre"], x["ring"], x["onehot"], x["post_t"], x["post_s"], cols,
                work_w, plastic, dev.row_len, stdp=stdp, own=(0, n_p), weights_out=work_w), 5)
        else:
            tp = cuda_ms(lambda cl=cl: ref.fused_post_exchange_plastic_ref(
                x["act"], x["pre"], x["ring"], cl, x["onehot"], x["post_t"], x["post_s"], cols,
                work_w, plastic, dev.row_len, stdp=stdp, weights_out=work_w), 5)
        say("timing", f"{name} ({nd} buckets, {real} real slots of {slots}, {n_pl} plastic, "
            f"{n_act} non-plastic under an active id, partition 0; row_len, weights in "
            f"place): kernel {tk:.4f} ms ({nb / tk / 1e6:.0f} GB/s of the bound's traffic), "
            f"plain {tp:.3f} ms, bound {b:.4f} ms ({nb / 1e9:.4f} GB): {b / tk:.0%}; 16 B a "
            f"real slot [{b_16:.4f} ms, {b_16 / tk:.0%}]; every slot [{b_pad:.4f} ms]")
        out.append(dict(name=name, ms=tk, plain_ms=tp, bound_ms=b, bound_by=by,
                        library_ms=None, bound_ms_16b_a_real_slot=b_16, bound_ms_every_slot=b_pad,
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
    then the live session 200 steps and ``Session.restore`` onto the card in
    a fresh process (``phase_ingest``, eager and streamed), 200 steps of
    each; rasters, spike counts, ``vtx_state``, ``ring``, ``hist`` and the
    traces bit-equal.  Then ``[super] main`` on the same snapshot."""
    part = ses.net.parts[0]
    arrays = {key: getattr(part, key).nbytes for key in BUILD_ARRAYS}
    need = sum(arrays.values()) + sum(ses.state[key].numel() * ses.state[key].element_size()
                                      for key in ("ring", "hist", "tr_plus", "tr_minus"))
    require_disk(need + need // 20)
    path = SNAP_ROOT / "microcircuit"
    stall, write, n_bytes = timed_save(ses, path)
    say("snap", save_line(f"microcircuit k=1 (n={ses.n}, m={ses.m})", ses, stall, write,
                          n_bytes, smi))
    say("snap", "arrays (GB): " + ", ".join(f"{key} {b / 1e9:.3f}" for key, b in arrays.items()))
    live_st0 = ses.state  # runs never change a caller's state: the rewind point
    live_res, _, live, live_s = run_session(ses, VARIANT_STEPS)
    require(int(live.raster.sum()) > 0, "the live microcircuit never spiked")
    phase_ingest(ses, path, live_st0, live_res, live, live_s)
    phase_super_main(ses, path, live_st0, n_bytes, smi)
    ses.close()  # the background writer's thread ends here


SUPER_STEPS, SUPER_CHUNK, SUPER_EVERY, SUPER_KEEP = 256, 64, 128, 2
CHAOS_STEPS, CHAOS_CHUNK, CHAOS_EVERY = 512, 128, 128
# [chaos]: each chaos plan over a checkpointed run, and the storm
PLAN_STEPS, PLAN_EVERY, PLAN_KEEP = 256, 64, 2
FAULT_SEED = 5  # the seed of every FaultPlan of the [super] and [chaos] phases
CARRY_KEYS = ("vtx_state", "ring", "hist", "tr_plus", "tr_minus")


def sha(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def carry_digest(state):
    """A digest of every carry array but the weights, partition by
    partition."""
    return sha(*(c[key].cpu().numpy() for c in carries_of(state) for key in CARRY_KEYS))


class Launcher:
    """A small process started before the script grows, which starts the
    restore children on request: a child's ``ru_maxrss`` starts at its
    parent's, so a child of this script's main process would report that
    process's peak, not its own.  ``run(argv)`` gives ``(returncode, stdout,
    stderr)``; ``close()`` ends it."""

    CODE = ("import json, subprocess, sys\n"
            "for line in sys.stdin:\n"
            "    try:\n"
            "        out = subprocess.run(json.loads(line), capture_output=True, text=True,"
            " timeout=900)\n"
            "        res = [out.returncode, out.stdout, out.stderr]\n"
            "    except subprocess.TimeoutExpired as e:\n"
            "        res = [-9, str(e.stdout), 'timed out']\n"
            "    print(json.dumps(res), flush=True)\n")

    def __init__(self):
        self.proc = subprocess.Popen([sys.executable, "-c", self.CODE], stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, text=True)

    def run(self, argv):
        self.proc.stdin.write(json.dumps(argv) + "\n")
        self.proc.stdin.flush()
        return json.loads(self.proc.stdout.readline())

    def close(self):
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


LAUNCHER = []  # the one Launcher, made at the start of main()


def restore_child(path, streaming):
    """The body of ``--restore-child``: ``Session.restore(path)`` (or with
    ``streaming=True``) onto the card in this fresh process, its peak RSS
    (``ru_maxrss``) after the load and after the build,
    ``restore_seconds``, its t, device and reduce, a digest of the restored
    carry, then 200 steps and the digests of their raster, spike counts and
    end carry, as one ``RESTORE_CHILD {json}`` line."""
    from repro_torch.snn import session as session_mod

    rss = dict(start=host_rss_gib())
    load = session_mod.load_latest_valid

    def load_and_read_rss(*a, **kw):
        out = load(*a, **kw)
        rss["load"] = host_rss_gib()
        return out

    session_mod.load_latest_valid = load_and_read_rss
    ses = Session.restore(path, streaming=streaming)
    torch.cuda.synchronize()
    rss["build"] = host_rss_gib()
    start = carry_digest(ses.state)
    t, device, reduce = ses.t, ses.device.type, ses.describe()["reduce"]
    engine = ses.engine_choice.engine
    res, _, raster, secs = run_session(ses, VARIANT_STEPS)
    print("RESTORE_CHILD " + json.dumps(dict(
        streaming=streaming, t=t, device=device, reduce=reduce, seconds=ses.restore_seconds,
        engine=engine, rss_gib=rss, carry=start, raster=sha(raster.raster),
        spikes=int(raster.raster.sum()), spike_count=sha(res.spike_count),
        end=carry_digest(ses.state), modes=ses.last_gather_modes,
        us_per_step=secs / VARIANT_STEPS * 1e6)))
    return 0


def phase_ingest(ses, path, live_st0, live_res, live, live_s):
    """[snap] and [ingest]: the microcircuit's snapshot restored onto the
    card in a fresh process each, ``Session.restore(path)`` and
    ``Session.restore(path, streaming=True)``: each child's t, device and
    gathers' reduction equal the live session's, its carry bit-equal (by
    digest) to the live session's at the save, and its 200 steps' raster,
    spike counts and end carry equal to the live session's; with each
    child's peak RSS after the load and after the build and its
    ``restore_seconds``."""
    want = dict(carry=carry_digest(live_st0), raster=sha(live.raster),
                spike_count=sha(live_res.spike_count), end=carry_digest(ses.state))
    got = {}
    for streaming in (False, True):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--restore-child", str(path)]
        rc, stdout, stderr = LAUNCHER[0].run(cmd + (["--streaming"] if streaming else []))
        lines = [x for x in stdout.splitlines() if x.startswith("RESTORE_CHILD ")]
        require(rc == 0 and len(lines) == 1,
                f"restore child (streaming={streaming}) exited {rc}: {stdout[-2000:]} "
                f"{stderr[-4000:]}")
        r = got[streaming] = json.loads(lines[0].split(" ", 1)[1])
        require(r["t"] == int(live_st0["t"]) and r["device"] == "cuda",
                f"restored t {r['t']} or device {r['device']}")
        require(tuple(r["reduce"]) == tuple(ses.describe()["reduce"]),
                f"restored reduce {r['reduce']}")
        for key, digest in want.items():
            require(r[key] == digest, f"restore child (streaming={streaming}): {key} digest "
                    f"{r[key]} differs from the live session's {digest}")
        rs, rss = r["seconds"], r["rss_gib"]
        if not streaming:
            say("snap", f"Session.restore(path) onto the card, in a fresh process: "
                f"load_latest_valid {rs['load']:.3f} s, reshard {rs['reshard']:.3f} s, Session "
                f"build (ELL, upload) {rs['build']:.3f} s; engine {r['engine']}, k=1; its peak "
                f"RSS {rss['build']:.1f} GiB")
            say("snap", f"live and restored microcircuit, {VARIANT_STEPS} steps each (gather "
                f"modes {ses.last_gather_modes} and {tuple(r['modes'])}): {r['spikes']} spikes, "
                f"raster, spike counts, vtx_state, ring, hist and traces bit-equal (by digest); "
                f"{live_s / VARIANT_STEPS * 1e6:.1f} and {r['us_per_step']:.1f} us/step")
        say("ingest", f"fresh process, Session.restore(path{', streaming=True' if streaming else ''})"
            f" onto the card: load {rs['load']:.3f} s, build {rs['build']:.3f} s; peak RSS "
            f"(ru_maxrss) {rss['start']:.2f} GiB at start, {rss['load']:.2f} after the load, "
            f"{rss['build']:.2f} after the build; vtx_state, ring, hist and traces bit-equal "
            f"to the live session at t={r['t']}; {VARIANT_STEPS} steps: raster ({r['spikes']} "
            f"spikes), spike counts and end carry equal to the live session's; "
            f"{r['us_per_step']:.1f} us/step")
    e, st = got[False], got[True]
    peak = {k: "the load" if r["rss_gib"]["load"] >= r["rss_gib"]["build"] else "the build"
            for k, r in got.items()}
    say("ingest", f"eager against streamed: load {e['seconds']['load']:.3f} / "
        f"{st['seconds']['load']:.3f} s, build {e['seconds']['build']:.3f} / "
        f"{st['seconds']['build']:.3f} s, child peak RSS {e['rss_gib']['build']:.2f} / "
        f"{st['rss_gib']['build']:.2f} GiB (after the load {e['rss_gib']['load']:.2f} / "
        f"{st['rss_gib']['load']:.2f}); the whole restore's peak is set by {peak[False]} "
        f"(eager) and {peak[True]} (streamed); the snapshot's file was in the page cache "
        f"(written by this process); this process, which built the net, read "
        f"{host_rss_gib():.1f} GiB")


def graph_keys(sim):
    """Each captured key's label and set-up seconds: a key captured again
    would show new seconds."""
    return {key: (g.what, g.warmup_s, g.capture_s) for key, g in sim._graphs.graphs.items()}


def phase_super_main(ses, path, live_st0, n_bytes, smi):
    """[super] main: the main path's session, rewound to the snapshot's
    step, runs ``run_supervised(256, chunk_size=64, checkpoint_every=128,
    max_to_keep=2)`` (the snapshot, moved into the checkpoint root, is the
    first rollback target); the port's ``FaultPlan([Fault("supervisor:state",
    "nan", after=2, count=1)], seed=FAULT_SEED)`` puts a NaN into one
    membrane, drawn from the seed as the reference's plan draws it, after
    the third chunk, which rolls the run back to t0 + 128.  Raster, spike
    counts, ``vtx_state``, ring and hist bit-equal to an undisturbed
    ``run(256, chunk_size=64)`` from the same state; the simulator object
    and its captured graphs are the same after the rollback, with no key
    added or captured again."""
    sim = ses.simulator
    t0 = int(live_st0["t"])
    root = SNAP_ROOT / "super_main"
    root.mkdir()
    os.replace(path, root / f"step_{t0:08d}")
    require_disk(2 * n_bytes + n_bytes // 10)
    ses._state = live_st0
    sim.set_gather("dense")
    plain = RasterMonitor()
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    res_plain = ses.run(SUPER_STEPS, monitors=[plain], chunk_size=SUPER_CHUNK)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t_run
    want_end = ses.state
    keys0 = graph_keys(sim)

    plan = FaultPlan([Fault("supervisor:state", "nan", after=2, count=1)], seed=FAULT_SEED)
    # the plan's own draw over the carry's rows
    nan_row = int(plan.rng_for(0, 0).integers(0, live_st0["vtx_state"].shape[0]))
    ses._state = live_st0
    sim.set_gather("dense")
    mon = RasterMonitor()
    reset_counts()
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    with plan, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = ses.run_supervised(SUPER_STEPS, monitors=[mon], chunk_size=SUPER_CHUNK,
                                 checkpoint_every=SUPER_EVERY, checkpoint_dir=str(root),
                                 max_to_keep=SUPER_KEEP)
    torch.cuda.synchronize()
    sup_s = time.perf_counter() - t_run
    launches = read_counts()
    require(plan.fired == [("supervisor:state", None, "nan")], f"faults fired {plan.fired}")
    require(res.rollbacks == 1 and res.steps_lost == SUPER_CHUNK,
            f"rollbacks {res.rollbacks}, steps lost {res.steps_lost}")
    require(res.t_final == t0 + SUPER_STEPS and ses.t == t0 + SUPER_STEPS, f"t {ses.t}")
    require(np.array_equal(mon.raster, plain.raster) and int(plain.raster.sum()) > 0,
            "the supervised raster differs from the undisturbed run's")
    require(np.array_equal(res.spike_count, res_plain.spike_count), "spike counts differ")
    require_states_bit_equal(ses.state, want_end, "supervised vs undisturbed end state")
    require(ses.simulator is sim, "the rollback replaced the simulator")
    keys1 = graph_keys(sim)
    require(keys1 == keys0, f"graph keys added or captured again: {len(keys0)} -> {len(keys1)}")
    (rb,) = ses.last_rollbacks
    require(rb["in_place"] and (rb["t_from"], rb["t_to"]) == (t0 + 3 * SUPER_CHUNK,
                                                              t0 + SUPER_EVERY), f"rollback {rb}")
    steps = snapshot_steps(str(root))
    require(steps == [t0 + SUPER_EVERY, t0 + SUPER_STEPS], f"step dirs {steps}")
    stalls = ses.last_ckpt_stalls
    warned = [str(w.message) for w in caught if "rolled back" in str(w.message)]
    require(len(warned) == 1, f"rollback warnings {warned}")
    say("super", f"main: run_supervised({SUPER_STEPS}, chunk_size={SUPER_CHUNK}, "
        f"checkpoint_every={SUPER_EVERY}, max_to_keep={SUPER_KEEP}) from t0={t0}, a NaN in "
        f"membrane {nan_row} after chunk 3 from FaultPlan(seed={FAULT_SEED}): rollbacks {res.rollbacks}, steps lost "
        f"{res.steps_lost}, events {[(e.kind, e.t) for e in res.events]}; raster "
        f"({int(mon.raster.sum())} spikes), spike counts, vtx_state, ring and hist bit-equal to "
        f"the undisturbed run; the same simulator, {len(keys1)} graph keys before and after, none "
        f"captured again; step dirs {steps}; launches {launches}")
    say("super", f"main: the rollback {rb['t_from']} -> {rb['t_to']}: writer drain "
        f"{rb['drain']:.3f} s, restore_resilient {rb['restore']:.3f} s, in-place reload "
        f"{rb['reload']:.3f} s (topology check, vtx_state and runtime upload); supervised "
        f"{sup_s / SUPER_STEPS * 1e6:.1f} us/step ({sup_s:.3f} s, checkpoints, the rollback and "
        f"the re-run included) against plain {plain_s / SUPER_STEPS * 1e6:.1f} us/step; "
        f"checkpoint stalls {[round(x, 3) for x in stalls]} s; {smi}")
    shutil.rmtree(root)


def phase_super_chaos(spec, ses4, card, smi):
    """[super] k4p chaos: the Brunel rules net's k=4 spmd session (built on
    the card, so its manifest carries the RuleSpec) runs
    ``run_supervised(512, chunk_size=128, checkpoint_every=128)`` under one
    of the port's ``FaultPlan`` s holding three faults: a transient
    ``OSError`` on each shard path's first write (``per_path``; the
    writer's retries absorb it), a NaN in one membrane after chunk 2 (its
    partition and row drawn from the seed over the ``k * n_p`` rows, as the
    reference draws it over its stacked layout), and one seeded bit flip of
    the newest step's ``part0.npz`` at its first read, which is the
    rollback's.  The rollback quarantines that shard,
    regenerates partition 0 from the keystream on the card, and falls back
    to t0: 256 steps lost; raster, spike counts and the whole carry
    (``vtx_state``, every plastic weight, both traces) bit-equal to an
    undisturbed run, and ``net.parts[0]`` equal to a fresh
    ``build_partition``."""
    sim = ses4.simulator
    t0 = ses4.t
    st0 = ses4.state
    plain = RasterMonitor()
    res_plain = ses4.run(CHAOS_STEPS, monitors=[plain], chunk_size=CHAOS_CHUNK)
    want_end = ses4.state
    root = SNAP_ROOT / "super_chaos"
    require_disk(8 * sum(getattr(p, key).nbytes for p in ses4.net.parts for key in BUILD_ARRAYS))
    flip_at = os.path.join(f"step_{t0 + CHAOS_EVERY:08d}", "part0.npz")
    plan = FaultPlan([Fault("shard_write", "io_error", per_path=True),
                      Fault("supervisor:state", "nan", after=1, count=1),
                      Fault("shard_read", "bit_flip", match=flip_at, count=1)], seed=FAULT_SEED)
    n_p = st0[0]["vtx_state"].shape[0]
    nan_at = divmod(int(plan.rng_for(1, 0).integers(0, K_PARTS * n_p)), n_p)  # the plan's draw

    ses4._state = st0
    mon = RasterMonitor()
    reset_counts()
    t_run = time.perf_counter()
    with plan, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = ses4.run_supervised(CHAOS_STEPS, monitors=[mon], chunk_size=CHAOS_CHUNK,
                                  checkpoint_every=CHAOS_EVERY, checkpoint_dir=str(root))
    torch.cuda.synchronize()
    sup_s = time.perf_counter() - t_run
    launches = read_counts()
    kinds = [kind for _, _, kind in plan.fired]
    written = {path for _, path, kind in plan.fired if kind == "io_error"}
    require(kinds.count("nan") == 1 and kinds.count("bit_flip") == 1
            and kinds.index("nan") < kinds.index("bit_flip")
            and kinds.count("io_error") == len(written) > 0, f"faults fired {Counter(kinds)}")
    require(res.rollbacks == 1 and res.steps_lost == 2 * CHAOS_CHUNK,
            f"rollbacks {res.rollbacks}, steps lost {res.steps_lost}")
    (rep,) = res.restore_reports
    require(rep.regenerated == [0] and [ps for _, _, ps in rep.quarantined] == [[0]]
            and rep.t_now == t0, f"restore report {rep}")
    require(np.array_equal(mon.raster, plain.raster) and int(plain.raster.sum()) > 0,
            "the chaos run's raster differs from the undisturbed run's")
    require(np.array_equal(res.spike_count, res_plain.spike_count), "spike counts differ")
    require_states_bit_equal(ses4.state, want_end, "chaos vs undisturbed end state")
    (rb,) = ses4.last_rollbacks
    require(ses4.simulator is sim and rb["in_place"], "the rollback replaced the simulator")
    fresh, part = build_partition(spec, K_PARTS, 0, uniform=True, device=card), ses4.net.parts[0]
    for key in TOPOLOGY_FIELDS:
        require(np.array_equal(getattr(part, key), getattr(fresh, key)),
                f"net.parts[0].{key} differs from a fresh build_partition")
    # delays, and the weights STDP never changes
    fixed = fresh.edge_model != ses4.net.registry.edge_id("syn_stdp")
    require(np.array_equal(part.edge_state[:, EDGE_DELAY], fresh.edge_state[:, EDGE_DELAY])
            and np.array_equal(part.edge_state[fixed], fresh.edge_state[fixed]),
            "net.parts[0] delays or non-plastic weights differ from a fresh build_partition")
    require(launches["keystream"] > 0, f"no keystream launch regenerated partition 0: {launches}")
    say("super", f"k4p chaos: run_supervised({CHAOS_STEPS}, chunk_size={CHAOS_CHUNK}, "
        f"checkpoint_every={CHAOS_EVERY}) on the Brunel rules net, {K_PARTS} partitions on the "
        f"card, from t0={t0}, FaultPlan(seed={FAULT_SEED}): {kinds.count('io_error')} transient "
        f"shard write errors absorbed by the writer's retries, a NaN in partition {nan_at[0]} "
        f"row {nan_at[1]} after chunk 2, part0.npz of step {t0 + CHAOS_EVERY} bit-flipped at "
        f"its first read -> quarantined, fell back to t0: "
        f"rollbacks {res.rollbacks}, steps lost {res.steps_lost}, events "
        f"{[(e.kind, e.t) for e in res.events]}; raster ({int(mon.raster.sum())} spikes), spike "
        f"counts, vtx_state, every plastic weight and both traces bit-equal to the undisturbed "
        f"run; the same simulator; net.parts[0] equal to a fresh build_partition(spec, "
        f"{K_PARTS}, 0, uniform=True, device=card) in its topology arrays, delays and "
        f"non-plastic weights")
    say("super", f"k4p chaos: the rollback {rb['t_from']} -> {rb['t_to']}: writer drain "
        f"{rb['drain']:.3f} s, restore_resilient {rb['restore']:.3f} s (keystream regeneration of "
        f"partition 0 {rb['regenerate']:.3f} s, {launches['keystream']} keystream launches), "
        f"in-place reload {rb['reload']:.3f} s; {sup_s / CHAOS_STEPS * 1e6:.1f} us/step "
        f"supervised ({sup_s:.3f} s); checkpoint stalls "
        f"{[round(x, 3) for x in ses4.last_ckpt_stalls]} s; {smi}")
    shutil.rmtree(root)


def step_crcs(root):
    """``file_crc`` of every file of every step directory under ``root``."""
    return {f"{d.name}/{f.name}": file_crc(str(f))
            for d in sorted(Path(root).iterdir()) for f in sorted(d.iterdir())}


def phase_chaos(ses4, smi):
    """[chaos] on the Brunel rules net's k=4 session, from one start state:
    ``run(256, checkpoint_every=64, max_to_keep=2)`` clean, then under each
    of the port's ``chaos_plan(name, seed=0)`` (transient-io, torn-write,
    slow-disk), each into a fresh root with the writes drained inside the
    plan: the end carry bit-equal to the clean run's, every file of every
    kept step equal to the clean run's by ``file_crc``, and the plan fired.
    Then the storm: ``run_supervised(256, chunk_size=64,
    checkpoint_every=64)`` under ``Fault("supervisor:state", "storm",
    after=1, count=1)``, 1e4 in every membrane after chunk 2, caught on
    that chunk by the membrane ceiling ``HealthConfig().max_vm`` reduced on
    the card: one rollback of 64 steps, in place, and the end carry
    bit-equal to the clean run's."""
    st, t0 = ses4.state, ses4.t
    require_disk(8 * sum(getattr(p, key).nbytes for p in ses4.net.parts for key in BUILD_ARRAYS))

    def checkpointed_run(root):
        ses4._state = st
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        ses4.run(PLAN_STEPS, checkpoint_every=PLAN_EVERY, checkpoint_dir=str(root),
                 max_to_keep=PLAN_KEEP)
        torch.cuda.synchronize()
        t_wait = time.perf_counter()
        ses4.wait()
        run_s, drain_s = t_wait - t_run, time.perf_counter() - t_wait
        return run_s / PLAN_STEPS * 1e6, drain_s, [round(x, 3) for x in ses4.last_ckpt_stalls]

    root = SNAP_ROOT / "chaos_clean"
    with no_faults():
        clean = checkpointed_run(root)
    want_end, crcs = ses4.state, step_crcs(root)
    n_bytes = sum(snapshot_bytes(d) for d in root.iterdir())
    steps = sorted({key.split("/")[0] for key in crcs})
    require(len(steps) == PLAN_KEEP and len(crcs) == PLAN_KEEP * (K_PARTS + 1),
            f"kept {sorted(crcs)}")
    shutil.rmtree(root)
    for name in CHAOS_PLANS:
        root = SNAP_ROOT / f"chaos_{name}"
        with chaos_plan(name, seed=0) as plan:
            got = checkpointed_run(root)
        kinds = Counter(kind for _, _, kind in plan.fired)
        require(kinds, f"{name}: the plan never fired")
        require_states_bit_equal(ses4.state, want_end, f"{name} vs clean end state")
        require(step_crcs(root) == crcs, f"{name}: the kept steps' files differ from the clean "
                f"run's: {step_crcs(root)} against {crcs}")
        shutil.rmtree(root)
        say("chaos", f"{name}: run({PLAN_STEPS}, checkpoint_every={PLAN_EVERY}, "
            f"max_to_keep={PLAN_KEEP}) on the Brunel rules net, {K_PARTS} partitions on the card, "
            f"from t0={t0} under chaos_plan({name!r}, seed=0): fired {dict(kinds)}; end carry "
            f"bit-equal to the clean run's; the {len(crcs)} files of steps {steps} "
            f"({n_bytes / 1e9:.3f} GB) equal to the clean run's by file_crc; {got[0]:.1f} us/step "
            f"to the run's return (clean {clean[0]:.1f}), writer drain {got[1]:.3f} s (clean "
            f"{clean[1]:.3f}), checkpoint stalls {got[2]} s (clean {clean[2]}); {smi}")

    root = SNAP_ROOT / "chaos_storm"
    plan = FaultPlan([Fault("supervisor:state", "storm", after=1, count=1)], seed=FAULT_SEED)
    ses4._state = st
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    with plan, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = ses4.run_supervised(PLAN_STEPS, chunk_size=PLAN_EVERY, checkpoint_every=PLAN_EVERY,
                                  checkpoint_dir=str(root))
    torch.cuda.synchronize()
    sup_s = time.perf_counter() - t_run
    max_vm = HealthConfig().max_vm
    require(plan.fired == [("supervisor:state", None, "storm")], f"faults fired {plan.fired}")
    require(res.rollbacks == 1 and res.steps_lost == PLAN_EVERY,
            f"rollbacks {res.rollbacks}, steps lost {res.steps_lost}")
    ev = res.events[0]
    require(ev.kind == "health" and ev.t == t0 + 2 * PLAN_EVERY
            and ev.detail.startswith("membrane runaway") and f"ceiling {max_vm}" in ev.detail,
            f"events {res.events}")
    require_states_bit_equal(ses4.state, want_end, "storm vs clean end state")
    (rb,) = ses4.last_rollbacks
    require(rb["in_place"] and (rb["t_from"], rb["t_to"]) == (t0 + 2 * PLAN_EVERY,
                                                              t0 + PLAN_EVERY), f"rollback {rb}")
    warned = [str(w.message) for w in caught if "rolled back" in str(w.message)]
    require(len(warned) == 1, f"rollback warnings {warned}")
    shutil.rmtree(root)
    say("chaos", f"storm: run_supervised({PLAN_STEPS}, chunk_size={PLAN_EVERY}, "
        f"checkpoint_every={PLAN_EVERY}) on the same session from t0={t0} under "
        f"Fault('supervisor:state', 'storm', after=1, count=1): every membrane set to 1e4 after "
        f"chunk 2, caught on that chunk by the ceiling max_vm={max_vm} reduced on the card "
        f"({ev.detail!r}); rollbacks {res.rollbacks}, steps lost {res.steps_lost}, "
        f"{rb['t_from']} -> {rb['t_to']} in place (drain {rb['drain']:.3f} s, restore_resilient "
        f"{rb['restore']:.3f} s, reload {rb['reload']:.3f} s); end carry bit-equal to the clean "
        f"run's; {sup_s / PLAN_STEPS * 1e6:.1f} us/step supervised ({sup_s:.3f} s); checkpoint "
        f"stalls {[round(x, 3) for x in ses4.last_ckpt_stalls]} s; {smi}")


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
    st_ck = ses4.state
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
    # the same checkpointed run graphed and uncaptured, from the same state
    phase_graph("k4p checkpointed", ses4, st_ck, "dense", CKPT_STEPS, ckpt_mon.raster,
                after=ses4.wait, measure=False, order=(True, False), checkpoint_every=CKPT_EVERY,
                checkpoint_dir=str(SNAP_ROOT / "ckpt_ab"), max_to_keep=CKPT_KEEP)
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


def phase_rules_brunel(seed, card, smi):
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
    st1, st4 = ses1.state, ses4.state
    reset_counts()
    _, _, r1, s1 = run_session(ses1, PARITY_STEPS)
    l1 = read_counts()
    require(l1 == only(fused_plastic_step=PARITY_STEPS, noise_add=PARITY_STEPS),
            f"k=1 launches {l1}")
    reset_counts()
    _, _, r4, s4 = run_session(ses4, PARITY_STEPS)
    l4 = read_counts()
    phase_graph("p2 k=1", ses1, st1, "dense", PARITY_STEPS, r1.raster)
    phase_graph(f"p2 k={K_PARTS}", ses4, st4, "dense", PARITY_STEPS, r4.raster)
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
    phase_idle()
    del ses1
    phase_super_chaos(spec, ses4, card, smi)
    phase_chaos(ses4, smi)
    ses4.close()


def phase_rules_microcircuit(args, card, after_build=None):
    """p3: the slice's main path, ``Session(microcircuit_rules(scale))`` with
    the keystream on the card, then 1000 steps, then rows of the card-built
    net against the numpy oracle's ``build_partition``.  ``after_build`` is
    called between the build and the run (the training child's join)."""
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
    if after_build is not None:
        after_build()
    pops = {p: spec.offsets()[p] for p in (q.name for q in spec.populations)}
    st0 = ses.state
    raster, run_launches = phase_main_path(ses, ses.n, pops, tag="p3", need_event=False)
    phase_graph("p3", ses, st0, "dense", STEPS, raster)

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
    phase_idle()
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
    ap.add_argument("--restore-child", metavar="PATH", help=argparse.SUPPRESS)
    ap.add_argument("--streaming", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--reduced", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--lm-child", choices=("serve", "train"), help=argparse.SUPPRESS)
    ap.add_argument("--t-offset", type=float, default=0.0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the card",
              file=sys.stderr)
        return 1
    if args.restore_child:  # the [ingest] phase's fresh process
        return restore_child(args.restore_child, args.streaming)
    if args.mesh_child:  # the [mesh] phase's process group
        return mesh_child(args.seed, args.reduced)
    if args.lm_child:  # the dense LMs served and four families trained
        return lm_child(args.lm_child, args.seed, args.t_offset)
    LAUNCHER.append(Launcher())
    global T_START
    T_START = t_start = time.perf_counter()
    name, count, smi = phase_device()
    phase_build()
    start_dry_runs()
    card = torch.device("cuda", torch.cuda.current_device())
    phase_contracts(card)
    phase_lm(card, args.seed, smi)
    phase_train(card, args.seed, smi)
    phase_mesh(args.seed, smi)
    serve_child = start_lm_child("serve", args.seed, "the host's microcircuit build")

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
    join_lm_child(serve_child)  # before the parent's next allocation on the card
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
    st0 = ses.state
    main_raster, launches = phase_main_path(ses, net.n, pd14_populations(args.scale))
    phase_graph("main", ses, st0, "dense", STEPS, main_raster)
    errs["event_post_exchange"], event_act = phase_event(sim, main_raster, inputs[4])
    unfused = phase_parity(net, main_raster, len(sim.dev.cols), ses)
    phase_maxk("microcircuit", net, SimConfig(max_k=512), main_raster[STEPS // 2], main_raster)
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
    st0 = ses4.state
    k4_raster, k4_launches, _ = phase_k4_main(ses4, main_raster, base)
    phase_graph("k4", ses4, st0, "dense", STEPS, k4_raster)
    phase_k4_variants(ses4, card, k4_raster, len(dsim.devs[0].cols))
    kernels += phase_k4_timing(dsim, k4_act, k4_errs, k4_launches)
    phase_k4_engines(ses4)
    phase_k4_front_host(ses4, params)
    k4_olds = {g: [("the old chain", front_engine_ab("front", dsim, g, ses4.state)[0])]
               for g in ("dense", "event")}
    # torch.profiler only now, after every timed k=1 and k>1 microcircuit run
    phase_step_kernels("front", sim, ses.state, k1_olds)
    phase_step_kernels("front", dsim, ses4.state, k4_olds)
    phase_idle()
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
    st0 = pses.state
    p_raster, p_launches = phase_plastic_path(pses, pnet.n)
    # the fused plastic kernel adds the currents into the ring itself: 16
    # kernels a step, 31 with an index_add_ a bucket
    phase_graph("plastic", pses, st0, "dense", STEPS, p_raster, max_kernels=16)
    unf, fus, unf_launches = phase_plastic_parity(pnet, p_raster)
    phase_maxk("brunel", pnet, SimConfig(max_k=64, align_k=32), p_raster[STEPS // 2], p_raster)
    # stdp_update runs only on the unfused plastic path: its count is that run's
    p_launches["stdp_update"] = unf_launches["stdp_update"]
    phase_plastic_engines(pses, unf)
    phase_plastic_small_net(args.seed)
    kernels += phase_plastic_timing(psim, pparams, p_inputs, p_errs, p_launches)
    # row 10 on the Brunel [maxk] panels (split buckets, post terms through
    # the row map) beside its figures on the unsplit panels
    mk = MAXK["brunel"]["fig"]["stdp_update"]
    next(k for k in kernels if k["name"] == "stdp_update").update(
        {f"{key}_maxk": mk[key] for key in ("ms", "old_ms", "plain_ms", "bound_ms",
                                             "bound_ms_all_rows", "bound_ms_rows_4_7_8",
                                             "bound_ms_every_slot", "writes", "items")},
        launches_maxk=MAXK["brunel"]["launches"]["stdp_update"])

    t0 = time.perf_counter()
    pses4 = spmd_session(pd4, card)
    pdsim = pses4.simulator
    say("host", f"Session(engine='spmd', devices=[card] * {K_PARTS}) of the plastic net: "
        f"{time.perf_counter() - t0:.1f} s; {len(pdsim.devs[0].cols)} buckets of "
        f"{tuple(pdsim.devs[0].cols[0].shape)} a partition; engine {pses4.engine_choice}")
    k4p_inputs, k4p_errs = phase_k4_plastic_kernels(pdsim, pparams,
                                                    np.random.default_rng(args.seed))
    st0 = pses4.state
    k4p_launches = phase_k4_plastic_path(pses4, pses, p_raster)
    phase_graph("k4p", pses4, st0, "dense", STEPS, p_raster)
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
    phase_idle()
    phase_snapshot_brunel(pses4, card, smi)
    del pses4, pdsim, pses, psim, pnet, pd4, unf, fus, k4p_inputs, p_inputs
    gc.collect()
    torch.cuda.empty_cache()

    # procedural construction: RuleSpec -> build_network (keystream on the
    # card) -> Session
    ks_err = phase_keystream_kernel(args.seed, card)
    phase_rules_brunel(args.seed, card, smi)
    gc.collect()
    torch.cuda.empty_cache()
    train_child = start_lm_child("train", args.seed, "p3's build on the host")
    ks_launches, rules_fused = phase_rules_microcircuit(
        args, card, after_build=lambda: join_lm_child(train_child))
    gc.collect()
    torch.cuda.empty_cache()
    kernels.append(phase_keystream_timing(args.seed, card, ks_launches, ks_err))
    next(k for k in kernels if k["name"] == "fused_step")["launches_rules_microcircuit"] = \
        rules_fused
    kernels.append(maxk_entry())  # the heavy-row split's launch, on both [maxk] sessions
    say("graph", "us/step of each path, graphed / uncaptured (_graphs=False), host clock, "
        "in one call: " + "; ".join(
            f"{tag} {min(per[True]):.1f} / {min(per[False]):.1f}" for tag, per in GRAPH_US.items())
        + f" (one run each way); {smi}")
    say("done", f"every phase passed; whole script {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    child = any(a in sys.argv for a in ("--restore-child", "--mesh-child", "--lm-child"))
    try:
        sys.exit(main())
    finally:
        stop_dry_runs()
        stop_lm_child()
        for launcher in LAUNCHER:
            launcher.close()
        if not child:  # the parent owns the snapshots
            shutil.rmtree(SNAP_ROOT, ignore_errors=True)
