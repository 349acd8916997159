"""ELL gather-accumulate: the CUDA kernel ``csrc/spike_gather.cu`` and its
plain version.

Counterpart of ``repro/kernels/spike_gather.py:spike_gather_pallas``.
:func:`spike_gather_cuda` launches the kernel on CUDA tensors and raises on
any other; ``ops.spike_gather`` takes the plain version
(:func:`spike_gather_plain`, i.e. ``ref.spike_gather_ref``) only for CPU
tensors.  Weights are f32 or bf16 panels, widened exactly and accumulated
in f32 as the reference's wrapper does (``spike_gather.py:36-42``); any
float activity is cast to f32; the currents are f32.

The heavy-row split of ``SimConfig(max_k=...)`` (virtual rows, their
segment sums and the ring add) is ``segment_gather.py``'s one launch a
step.

The kernel reads only what carries information: a pack launch turns the
activity into a bitmask (one bit per id, set iff ``act != 0``), and the
gather reads each row's first ``row_len[r]`` cols, tests each source's bit
(in shared memory) and loads a weight and an activity only for a set bit.
``row_len`` is the ``(R,)`` int32 count of real slots per row, which the
ELL builder puts at ``0..row_len-1`` with ``(col 0, weight 0)`` after them;
``None`` takes every row as ``K`` long, which is as exact but reads the
padding's cols.  The result equals the dense ``row_dot`` kernels' bit for
bit (the argument is in ``csrc/common.cuh``).

Preconditions of the kernel: every col id lies in ``[0, len(activity))``
(the simulator checks it on the host when it builds the panels); the
activity is finite, and every product of a weight and an active source's
activity is exact in f32 (always so for 0/1 spike vectors): a skipped slot
then adds nothing to the sum.  The active variant runs where ``reduce``
is the choice recorded from the weights (``dispatch.panel_reduce``:
``active`` only where they are all finite); otherwise the kernel's row_dot
variant runs, the same launch reducing every slot with ``row_dot``, whose
NaN rows are the reference's.  ``reduce="row_dot"``, the default, is the
bit-exact oracle of the active variant on the card.  The plain version
ignores ``row_len`` and ``reduce``: the slots past ``row_len`` are zero,
and it sums every slot.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .dispatch import launch_row_dot
from .ref import spike_gather_ref as spike_gather_plain

COUNTER = _build.LaunchCounter("spike_gather")

__all__ = ["COUNTER", "spike_gather_cuda", "spike_gather_plain"]


def spike_gather_cuda(
    activity: torch.Tensor,
    cols: torch.Tensor,
    weights: torch.Tensor,
    row_len: Optional[torch.Tensor] = None,
    *,
    reduce="row_dot",
    shared_bitmask: bool = True,
) -> torch.Tensor:
    """Launch the kernel: ``(R,)`` f32 currents.  ``reduce``: ``"row_dot"``
    or a one-panel sequence (the engines pass the choice recorded at
    upload; ``dispatch.launch_row_dot``).  ``shared_bitmask=False`` reads
    the bitmask from device memory, the path a vector too long for shared
    memory takes anyway (for tests and timing)."""
    if activity.dtype.is_floating_point:
        activity = activity.float()  # itself when already f32
    _build.require("activity", activity, torch.float32, 1)
    dev = activity.device
    _build.require("cols", cols, torch.int32, 2, dev)
    w_bf16 = _build.require_weights("weights", weights, dev)
    if cols.shape != weights.shape:
        raise ValueError(
            f"cols {tuple(cols.shape)} and weights {tuple(weights.shape)} differ"
        )
    R, K = cols.shape
    if row_len is not None:
        _build.require("row_len", row_len, torch.int32, 1, dev)
        if row_len.shape[0] != R:
            raise ValueError(f"row_len {tuple(row_len.shape)} for {R} rows")
    out = torch.empty(R, dtype=torch.float32, device=dev)
    if R == 0 or K == 0:
        return out.zero_()
    dense = launch_row_dot(reduce, [weights])
    n = activity.shape[0]
    bits = torch.empty(0 if dense else -(-n // 32), dtype=torch.int32, device=dev)
    stream, device = _build.launch_args(activity)
    rc = _build.library().repro_spike_gather(
        activity.data_ptr(), n, cols.data_ptr(), weights.data_ptr(), w_bf16,
        None if row_len is None else row_len.data_ptr(), bits.data_ptr(),
        out.data_ptr(), R, K, -1 if shared_bitmask else 0, int(dense), stream, device,
    )
    _build.check(rc, "spike_gather")
    COUNTER.launches += 1
    return out
