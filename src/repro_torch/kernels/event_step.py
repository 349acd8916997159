"""Event-driven post-exchange step: the cooperative CUDA kernel
``csrc/event_step.cu`` and its plain version.

Counterpart of ``repro/kernels/event_step.py``.  Each delay bucket's panel
is cut into row blocks, and a build-time ``touch`` bitmap records which
presynaptic ids appear in a valid slot of each block.  Per step:

  1. the spike vector is compressed to at most ``cap`` spike ids;
  2. a row block is *flagged* iff an active id touches it; more active ids
     than ``cap`` flag every block (a dense sweep in that step, never a
     wrong answer);
  3. the delivered ring slot is cleared, and only the flagged rows of each
     bucket are gathered and added to their ring slot, bucket by bucket.

The kernel also packs the activity into a bitmask (one bit per id, set iff
``act != 0``) and stages it in each block's shared memory; a flagged row's
gather reads its first ``row_len[r]`` cols, tests each source's bit and
loads a weight and an activity only for a set bit, so neither the padding
nor the weights of silent sources cross the memory bus.  ``row_len`` is
per bucket the ``(R,)`` int32 count of real slots per row
(``PartitionDeviceData.row_len``); ``None`` takes every row as ``K`` long.
The plain version ignores it: the slots past it are ``(col 0, weight 0)``.
Weights are f32 or bf16 panels, one type for every bucket of a launch,
widened exactly and summed in f32 as the reference's kernel does
(``event_step.py:154``); the plain version widens with ``.float()``.
Preconditions, as for ``spike_gather``: finite activity, and every product
of a weight and an active source's activity exact in f32 (always so for 0/1
spike vectors).  Weights that are not all finite (recorded ``row_dot``
by ``dispatch.panel_reduce``) take the kernel's row_dot variant: the same
launch reducing every slot of a flagged row with ``row_dot``, whose NaN
rows are the reference's; ``reduce="row_dot"``, the default, is the
bit-exact oracle of the active variant on the card.  A row of an
unflagged block keeps its value whatever its weights, as the
reference's Pallas kernel keeps it (its oracle ``event_post_exchange_ref``
multiplies the row's gather by the flag, so a NaN weight there gives NaN).

The flags are conservative, so the ring equals the dense engines' ring on
every flagged row, and an unflagged row, whose dense sum is a signed zero,
keeps its value: the rasters of the event and the dense engines are
identical.  The reference's ``sel`` block selectors exist only to alias
TPU block fetches and have no counterpart here.

In the split engine (``fused_split_event``, k>1) the activity is the
exchanged ``(n_global,)`` vector, the touch bitmaps of each partition run
over ``n_global`` ids, and the ring has the partition's ``n_p`` rows; the
overlap mode's remote pass runs with no clear, where the reference passes a
clear mask of ones.

The ring slots come in one of two forms.  With ints, ``slot`` is the
delivered slot (None: no clear) and ``write_slots`` each bucket's slot.  The
simulator passes the step ``t`` itself as ``slot``, a 0-d int64 tensor on the
ring's device, and the buckets' delays as ``write_slots``: the delivered
slot is ``t % D`` (cleared unless ``clear=False``) and bucket b adds to ``(t
+ delays[b]) % D``.  The kernel reads ``t`` when it runs, so one captured
launch serves every step of a chunk; the int form is the same launch at
``t = slot``.

:func:`event_post_exchange_cuda` launches the kernel on CUDA tensors and
raises on any other; ``ops.event_post_exchange`` takes the plain version
(:func:`event_post_exchange_plain`) only for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .dispatch import launch_row_dot
from .ref import ring_row, spike_gather_ref

COUNTER = _build.LaunchCounter("event_post_exchange")

# size of the kernel's per-bucket argument table (csrc/event_step.cu)
MAX_BUCKETS = 32
# rows of a flag block: the granularity at which the event gather skips
EVENT_BLOCK_ROWS = 128

__all__ = [
    "COUNTER", "EVENT_BLOCK_ROWS", "EventPlan", "MAX_BUCKETS",
    "build_touch_masks", "event_block_geometry", "event_id_cap",
    "event_post_exchange_cuda", "event_post_exchange_plain",
    "event_select_plain",
]


def event_id_cap(n_global: int, cap_frac: float) -> int:
    """The compressed spike-id capacity (``SimConfig.event_cap_frac`` of
    the activity width, at least 32), as the reference computes it
    (``repro/kernels/dispatch.py:event_id_cap``)."""
    return max(int(cap_frac * n_global), 32)


def event_block_geometry(R: int, block_r: int = EVENT_BLOCK_ROWS) -> Tuple[int, int]:
    """``(block_r, num_blocks)`` for panels of ``R`` rows; the last block
    may be partial."""
    block_r = max(min(block_r, R), 1)
    return block_r, -(-R // block_r)


def build_touch_masks(
    cols: Sequence[np.ndarray],  # per delay bucket (R, K_d) presynaptic ids
    valid: Sequence[np.ndarray],  # per delay bucket (R, K_d) 0/1 validity
    n: int,  # width of the activity vector the ids index into
    num_blocks: int,
    block_r: int,
) -> List[np.ndarray]:
    """Per-bucket ``(num_blocks, n)`` uint8 bitmaps: ``touch[b, j] == 1``
    iff id ``j`` appears in a valid slot of row block ``b`` (a copy of the
    reference's builder that also takes a partial last block).  Padding
    slots are excluded, so an id that only padding references never flags
    a block."""
    masks = []
    for c, v in zip(cols, valid):
        c = np.asarray(c)
        v = np.asarray(v)
        assert -(-c.shape[0] // block_r) == num_blocks, (c.shape, num_blocks, block_r)
        m = np.zeros((num_blocks, n), np.uint8)
        for b in range(num_blocks):
            sl = slice(b * block_r, (b + 1) * block_r)
            ids = c[sl][v[sl] > 0]
            if ids.size:
                m[b, ids.astype(np.int64)] = 1
        masks.append(m)
    return masks


class EventPlan:
    """The event engine's static schedule for one partition: row-block
    geometry, the touch bitmaps stacked into one ``(nd, num_blocks, n)``
    uint8 tensor on the run's device, and the id-buffer capacity."""

    def __init__(self, block_r: int, num_blocks: int, cap: int, touch: torch.Tensor):
        self.block_r = int(block_r)
        self.num_blocks = int(num_blocks)
        self.cap = int(cap)
        self.touch = touch

    @classmethod
    def build(
        cls,
        cols: Sequence[np.ndarray],
        valid: Sequence[np.ndarray],
        n: int,
        cap: int,
        device,
        *,
        block_r: int = EVENT_BLOCK_ROWS,
    ) -> "EventPlan":
        block_r, nb = event_block_geometry(int(np.asarray(cols[0]).shape[0]), block_r)
        masks = build_touch_masks(cols, valid, n, nb, block_r)
        touch = torch.from_numpy(np.stack(masks)).to(device)
        return cls(block_r, nb, cap, touch)


def event_select_plain(act: torch.Tensor, touch: torch.Tensor, cap: int) -> torch.Tensor:
    """``(nd, num_blocks)`` int32 flags: a block is flagged iff an active id
    touches it, and every block is flagged when more than ``cap`` ids are
    active (the reference's ``event_select`` without its ``sel``)."""
    ids = torch.nonzero(act > 0).flatten()
    nd, nb, _ = touch.shape
    if ids.numel() > cap:
        return torch.ones((nd, nb), dtype=torch.int32, device=act.device)
    if ids.numel() == 0:
        return torch.zeros((nd, nb), dtype=torch.int32, device=act.device)
    return (touch.index_select(2, ids).amax(dim=2) > 0).to(torch.int32)


def ring_slots(ring: torch.Tensor, slot, write_slots: Sequence[int], clear: bool = True):
    """``(t, offsets, clear)`` of either form of the ring slots (module
    docstring): the step as an int or the caller's 0-d tensor, per bucket
    the offset of its write slot from ``t`` in ``[0, D)``, and whether the
    delivered slot ``t % D`` is cleared.  An int slot outside ``[0, D)``
    raises."""
    D = ring.shape[0]
    if torch.is_tensor(slot):
        return slot, [int(d) % D for d in write_slots], bool(clear)
    if not all(0 <= s < D for s in ((0 if slot is None else slot), *write_slots)):
        raise ValueError(f"ring slots {slot}, {tuple(write_slots)} outside [0, {D})")
    base = 0 if slot is None else int(slot)
    return base, [(int(s) - base) % D for s in write_slots], slot is not None


def event_post_exchange_plain(
    act: torch.Tensor,  # (n,) spike vector
    ring: torch.Tensor,  # (D, n_p) ring, updated in place
    slot,  # delivered slot, cleared (None: no clear), or the step t (module)
    write_slots: Sequence[int],  # per bucket (t + d) % D, or the delays
    plan: EventPlan,
    cols: Sequence[torch.Tensor],
    weights: Sequence[torch.Tensor],
    row_len: Optional[Sequence[torch.Tensor]] = None,  # ignored: see module
    *,
    reduce="row_dot",  # ignored: every slot is summed
    clear: bool = True,
) -> torch.Tensor:
    """The kernel's contract: clear the delivered slot (unless there is
    none), then per bucket in order add the flagged rows' gathers to its
    write slot; the slots in either form (module docstring), chosen with
    index ops on the ring's device.  Returns the flags."""
    t, offsets, clear = ring_slots(ring, slot, write_slots, clear)
    D, n_p = ring.shape
    rows_of = [ring_row(t + off, D, ring.device) for off in (0, *offsets)]
    flags = event_select_plain(act, plan.touch, plan.cap)
    if clear:
        ring.index_fill_(0, rows_of[0], 0.0)
    for b, (c, w, ws) in enumerate(zip(cols, weights, rows_of[1:])):
        rows = flags[b].repeat_interleave(plan.block_r)[:n_p].bool()
        cur = spike_gather_ref(act, c, w)[:n_p]
        before = ring.index_select(0, ws)[0]
        ring.index_copy_(0, ws, torch.where(rows, before + cur, before)[None])
    return flags


def event_post_exchange_cuda(
    act: torch.Tensor,
    ring: torch.Tensor,
    slot,
    write_slots: Sequence[int],
    plan: EventPlan,
    cols: Sequence[torch.Tensor],
    weights: Sequence[torch.Tensor],
    row_len: Optional[Sequence[torch.Tensor]] = None,
    *,
    reduce="row_dot",
    shared_bitmask: bool = True,
    clear: bool = True,
) -> torch.Tensor:
    """Launch the kernel (one cooperative launch); updates ``ring`` in place
    and returns the ``(nd, num_blocks)`` int32 flags.  ``slot`` and
    ``write_slots`` in either form (module docstring; ``clear`` applies to
    the tensor form, ``slot=None`` is the int form's no clear).
    ``row_len``: per bucket ``(R,)`` int32 real slots a row, or None.
    ``reduce``: ``"row_dot"`` or per bucket the recorded choice
    (``dispatch.launch_row_dot``).
    ``shared_bitmask=False`` reads the bitmask from L2, the path a vector
    too long for shared memory takes anyway (for tests and timing)."""
    nd = len(cols)
    if not 1 <= nd <= MAX_BUCKETS or len(weights) != nd or len(write_slots) != nd:
        raise ValueError(
            f"event_post_exchange takes 1..{MAX_BUCKETS} delay buckets with one "
            f"weight panel and write slot each, got {nd} col panels, "
            f"{len(weights)} weight panels and {len(write_slots)} write slots"
        )
    _build.require("act", act, torch.float32, 1)
    dev = act.device
    _build.require("ring", ring, torch.float32, 2, dev)
    _build.require("touch", plan.touch, torch.uint8, 3, dev)
    D, n_p = ring.shape
    n = act.shape[0]
    R = cols[0].shape[0]
    for i, (c, w) in enumerate(zip(cols, weights)):
        _build.require(f"cols[{i}]", c, torch.int32, 2, dev)
        _build.require_weights(f"weights[{i}]", w, dev, weights[0].dtype)
        if c.shape != w.shape or c.shape[0] != R or c.shape[1] < 1:
            raise ValueError(
                "event_post_exchange needs (R, K_d) col/weight panels with a "
                f"common R and K_d >= 1: {[tuple(c.shape) for c in cols]} vs "
                f"{[tuple(w.shape) for w in weights]}"
            )
    if R < n_p:
        raise ValueError(f"panels have R={R} rows for n_p={n_p} neurons")
    _build.check_row_len(row_len, nd, R, dev)
    if tuple(plan.touch.shape) != (nd, plan.num_blocks, n) or \
            plan.num_blocks * plan.block_r < R:
        raise ValueError(
            f"touch bitmaps {tuple(plan.touch.shape)} do not cover {nd} buckets "
            f"of {R} rows in blocks of {plan.block_r} over {n} ids"
        )
    t, offsets, clear = ring_slots(ring, slot, write_slots, clear)
    t_dev = _build.step_tensor(t, dev)
    flags = torch.empty((nd, plan.num_blocks), dtype=torch.int32, device=dev)
    if n_p == 0:
        return flags.zero_()
    dense = launch_row_dot(reduce, weights)
    ids = torch.empty(plan.cap, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    bits = torch.empty(0 if dense else -(-n // 32), dtype=torch.int32, device=dev)
    ptrs = ctypes.c_void_p * nd
    ints = ctypes.c_int * nd
    stream, device = _build.launch_args(act)
    rc = _build.library().repro_event_step(
        act.data_ptr(), n, plan.touch.data_ptr(),
        ids.data_ptr(), count.data_ptr(), plan.cap, flags.data_ptr(),
        ring.data_ptr(), n_p, t_dev.data_ptr(), D, int(clear),
        plan.num_blocks, plan.block_r, nd,
        ptrs(*[c.data_ptr() for c in cols]),
        ptrs(*[w.data_ptr() for w in weights]), int(weights[0].dtype == torch.bfloat16),
        ptrs(*([None] * nd if row_len is None else [rl.data_ptr() for rl in row_len])),
        ints(*[c.shape[1] for c in cols]),
        ints(*offsets),
        bits.data_ptr(), -1 if shared_bitmask else 0, int(dense),
        stream, device,
    )
    _build.check(rc, "event_post_exchange")
    COUNTER.launches += 1
    return flags
