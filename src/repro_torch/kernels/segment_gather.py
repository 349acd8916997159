"""The heavy-row split's step: the cooperative CUDA kernel
``csrc/segment_gather.cu`` and its plain version.

Counterpart of ``repro/kernels/spike_gather.py:spike_gather_pallas`` over a
split bucket's virtual rows, with the ``jax.ops.segment_sum`` over
``row_map`` and the ring add that the reference runs around it, bucket by
bucket (``repro/snn/simulator.py:644-655``): here every bucket of a
``SimConfig(max_k=...)`` step in one launch.  :func:`segment_gather_ring_cuda`
launches the kernel on CUDA tensors and raises on any other;
``ops.segment_gather_ring`` takes the plain version
(:func:`segment_gather_ring_plain`, i.e. ``ref.segment_gather_ring_ref``)
only for CPU tensors.

A split bucket's panel rows are virtual rows: real row ``r`` owns rows
``row_ptr[r] .. row_ptr[r+1]-1`` (contiguous, ascending), and its sum is the
ascending f32 sum, from ``+0.0``, of their gathers.  A bucket that is not
split (``row_ptr`` None) gives its first ``n_p`` rows as they are.  Each sum
is added into ``ring[(t + d) % D]`` with one f32 add, ``t`` read on the
ring's device.  The gathers are ``spike_gather``'s: a bucket recorded
``active`` (``dispatch.panel_reduce``) reads each row's first ``row_len[r]``
cols and only the weights of active sources, one recorded ``row_dot`` every
slot; both give ``row_dot``'s bits (``csrc/common.cuh``).

The kernel walks an upload-time table of tiles (:func:`segment_plan`): every
bucket's virtual rows cut into runs of rows of at most :data:`TILE_SLOTS`
slots (one row where a row is wider), so that the work is cut by virtual
rows and not by real rows.  ``PartitionDeviceData.segment`` holds it
beside the panels.

Preconditions of the kernel: as ``spike_gather``'s (every col id lies in
``[0, len(act))``, finite activity and exact products for the active
reduction); a bf16 panel starts 4-byte aligned.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .dispatch import launch_row_dot
from .ref import segment_gather_ring_ref

COUNTER = _build.LaunchCounter("segment_gather")

# size of the kernel's per-bucket argument table (csrc/segment_gather.cu)
MAX_BUCKETS = 32
# the most slots of a tile (one row, where a row is wider); chosen by timing
# on the H100 (csrc/segment_gather.cu)
TILE_SLOTS = 256
# where the kernel kept the activity: csrc/segment_gather.cu:Mode
MODES = ("activity in shared memory", "bitmask in shared memory", "device memory")

__all__ = [
    "COUNTER", "MAX_BUCKETS", "SegmentPlan", "TILE_SLOTS", "segment_gather_ring_cuda",
    "segment_gather_ring_plain", "segment_plan", "tile_rows",
]


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """The kernel's work over a split step's buckets, made at upload."""

    tiles: torch.Tensor  # (n_tiles, 3) int32: bucket, first virtual row, rows
    rows: Tuple[int, ...]  # per bucket the virtual rows gathered: row_ptr[-1], or n_p
    depth: Tuple[int, ...]  # per bucket the most virtual rows of a real row (0: not split)
    widths: Tuple[int, ...]  # per bucket the panel width K the tiles were cut for
    tile_slots: int  # the most slots of one tile (its rows times K)


def tile_rows(K: int) -> int:
    """Rows of a tile of a bucket ``K`` slots wide: at most
    :data:`TILE_SLOTS` slots, and one row where a row is wider than that."""
    return max(1, TILE_SLOTS // max(K, 1))


def segment_plan(row_ptr: Sequence[Optional[np.ndarray]], widths: Sequence[int], n_p: int,
                 device) -> SegmentPlan:
    """The tile table of a split step: per bucket its ``(n_p + 1,)`` offsets
    (None: not split, its first ``n_p`` rows) and its panel width ``K``.
    Tiles run bucket by bucket over consecutive virtual rows, each of
    :func:`tile_rows` rows (the last of a bucket fewer), so they cover every
    gathered virtual row once, in order."""
    rows = tuple(n_p if p is None else int(p[-1]) for p in row_ptr)
    depth = tuple(0 if p is None else int(np.diff(p).max(initial=0)) for p in row_ptr)
    parts, slots = [], 1
    for b, (r, K) in enumerate(zip(rows, widths)):
        T = tile_rows(K)
        r0 = np.arange(0, r, T, dtype=np.int64)
        parts.append(np.stack([np.full_like(r0, b), r0, np.minimum(T, r - r0)], axis=1))
        if r:
            slots = max(slots, min(T, r) * K)
    tiles = np.concatenate(parts).astype(np.int32) if parts else np.zeros((0, 3), np.int32)
    return SegmentPlan(torch.from_numpy(tiles).to(device), rows, depth,
                       tuple(int(K) for K in widths), slots)


def segment_gather_ring_plain(act, ring, t, delays, plan, cols, weights, row_len=None,
                              row_ptr=None, *, reduce="row_dot"):
    """The plain version (``ref.segment_gather_ring_ref``); ``row_len`` and
    ``reduce`` change nothing here: the slots past ``row_len`` are zero and
    every slot is summed."""
    return segment_gather_ring_ref(act, ring, t, delays, cols, weights,
                                   row_ptr or (None,) * len(cols), plan.depth)


def segment_gather_ring_cuda(
    act: torch.Tensor,
    ring: torch.Tensor,
    t,
    delays: Sequence[int],
    plan: SegmentPlan,
    cols: Sequence[torch.Tensor],
    weights: Sequence[torch.Tensor],
    row_len: Optional[Sequence[Optional[torch.Tensor]]] = None,
    row_ptr: Optional[Sequence[Optional[torch.Tensor]]] = None,
    *,
    reduce="row_dot",
    config: Optional[Dict] = None,
) -> torch.Tensor:
    """Launch the kernel (one cooperative launch); updates ``ring`` in place
    and returns it.  ``t``: an int or the 0-d int64 step on the ring's
    device.  ``delays``: per bucket its delay, no two the same modulo ``D``
    (the step has one bucket a delay and ``D`` >= the largest).  ``row_len``:
    per bucket ``(R,)`` int32 real slots a row, or None.  ``reduce``:
    ``"row_dot"`` or per bucket the recorded choice
    (``dispatch.launch_row_dot``).  ``config``, a dict, receives the
    launch's ``mode`` (:data:`MODES`: where the activity sits, which its
    size decides), ``warps`` a block, ``stages``, ``blocks`` and ``smem``
    bytes a block."""
    nd = len(cols)
    row_ptr = tuple(row_ptr) if row_ptr is not None else (None,) * nd
    if not 1 <= nd <= MAX_BUCKETS or any(len(x) != nd for x in (
            weights, delays, row_ptr, plan.rows)):
        raise ValueError(
            f"segment_gather_ring takes 1..{MAX_BUCKETS} delay buckets with one weight "
            f"panel, delay, row_ptr and plan entry each, got {nd} col panels, "
            f"{len(weights)} weight panels, {len(delays)} delays, {len(row_ptr)} row_ptr "
            f"and {len(plan.rows)} plan rows"
        )
    if act.dtype.is_floating_point:
        act = act.float()  # itself when already f32
    _build.require("act", act, torch.float32, 1)
    dev = act.device
    _build.require("ring", ring, torch.float32, 2, dev)
    _build.require("tiles", plan.tiles, torch.int32, 2, dev)
    D, n_p = ring.shape
    for i, (c, w, rp) in enumerate(zip(cols, weights, row_ptr)):
        _build.require(f"cols[{i}]", c, torch.int32, 2, dev)
        w_bf16 = _build.require_weights(f"weights[{i}]", w, dev, weights[0].dtype)
        if c.shape != w.shape or c.shape[1] < 1 or c.shape[1] != plan.widths[i]:
            raise ValueError(f"bucket {i}: cols {tuple(c.shape)} and weights "
                             f"{tuple(w.shape)} must be one (R, K) shape with K >= 1, the "
                             f"plan's K={plan.widths[i]}")
        if w_bf16 and w.data_ptr() % 4:
            raise ValueError(f"weights[{i}]: a bf16 panel must start 4-byte aligned")
        if rp is None:
            if c.shape[0] < n_p or plan.rows[i] != n_p:
                raise ValueError(f"bucket {i}: an unsplit panel of {c.shape[0]} rows and "
                                 f"{plan.rows[i]} planned for n_p={n_p}")
        else:
            _build.require(f"row_ptr[{i}]", rp, torch.int32, 1, dev)
            if rp.shape[0] != n_p + 1 or plan.rows[i] > c.shape[0]:
                raise ValueError(f"bucket {i}: row_ptr {tuple(rp.shape)} for n_p={n_p}, "
                                 f"{plan.rows[i]} planned virtual rows of {c.shape[0]}")
        if row_len is not None and row_len[i] is not None:
            _build.require(f"row_len[{i}]", row_len[i], torch.int32, 1, dev)
            if row_len[i].shape[0] != c.shape[0]:
                raise ValueError(f"row_len[{i}] {tuple(row_len[i].shape)} for "
                                 f"{c.shape[0]} rows")
    t_dev = _build.step_tensor(t, dev)
    if n_p == 0:
        return ring
    launch_row_dot(reduce, weights)  # validates reduce
    rowdot = [reduce == "row_dot" or r == "row_dot" for r in
              ((reduce,) * nd if isinstance(reduce, str) else tuple(reduce))]
    voff = np.concatenate([[0], np.cumsum(plan.rows)]).astype(np.int64)
    if voff[-1] >= 2**31:
        raise ValueError(f"{voff[-1]} virtual rows: the kernel indexes them with int32")
    vsum = torch.empty(int(voff[-1]), dtype=torch.float32, device=dev)
    n = act.shape[0]
    bits = torch.empty(0 if all(rowdot) else -(-n // 32), dtype=torch.int32, device=dev)
    offsets = [int(d) % D for d in delays]
    if len(set(offsets)) != nd:
        raise ValueError(f"delays {tuple(delays)} share a ring slot modulo D={D}: the "
                         "kernel adds every bucket's rows in parallel")
    ptrs = ctypes.c_void_p * nd
    ints = ctypes.c_int * nd
    out = (ctypes.c_int * 5)()
    stream, device = _build.launch_args(act)
    rc = _build.library().repro_segment_gather(
        act.data_ptr(), n, bits.data_ptr(), ring.data_ptr(), n_p, t_dev.data_ptr(), D,
        vsum.data_ptr(), plan.tiles.data_ptr(), plan.tiles.shape[0], plan.tile_slots, nd,
        ptrs(*[c.data_ptr() for c in cols]), ptrs(*[w.data_ptr() for w in weights]),
        int(weights[0].dtype == torch.bfloat16),
        ptrs(*[None if row_len is None or row_len[i] is None else row_len[i].data_ptr()
               for i in range(nd)]),
        ptrs(*[None if rp is None else rp.data_ptr() for rp in row_ptr]),
        ints(*[c.shape[1] for c in cols]), ints(*voff[:-1].tolist()), ints(*offsets),
        ints(*map(int, rowdot)), out, stream, device,
    )
    _build.check(rc, "segment_gather_ring")
    COUNTER.launches += 1
    if config is not None:
        config.update(mode=MODES[out[0]], warps=out[1], stages=out[2], blocks=out[3],
                      smem=out[4])
    return ring
