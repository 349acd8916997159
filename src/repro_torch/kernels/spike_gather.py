"""ELL gather-accumulate: the CUDA kernel ``csrc/spike_gather.cu`` and its
plain version.

Counterpart of ``repro/kernels/spike_gather.py:spike_gather_pallas``.
:func:`spike_gather_cuda` launches the kernel on CUDA tensors and raises on
any other; ``ops.spike_gather`` takes the plain version
(:func:`spike_gather_plain`, i.e. ``ref.spike_gather_ref``) only for CPU
tensors.  Weights are f32 on this path; bf16 panels are not ported yet.

Precondition of the kernel: every col id lies in ``[0, len(activity))``.
The simulator checks it on the host when it builds the panels.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import spike_gather_ref as spike_gather_plain

COUNTER = _build.LaunchCounter("spike_gather")

__all__ = ["COUNTER", "spike_gather_cuda", "spike_gather_plain"]


def spike_gather_cuda(
    activity: torch.Tensor, cols: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """Launch the kernel: ``(R,)`` f32 currents."""
    _build.require("activity", activity, torch.float32, 1)
    _build.require("cols", cols, torch.int32, 2, activity.device)
    _build.require("weights", weights, torch.float32, 2, activity.device)
    if cols.shape != weights.shape:
        raise ValueError(
            f"cols {tuple(cols.shape)} and weights {tuple(weights.shape)} differ"
        )
    R, K = cols.shape
    out = torch.empty(R, dtype=torch.float32, device=activity.device)
    if R == 0:
        return out
    if K == 0:
        return out.zero_()
    stream, device = _build.launch_args(activity)
    rc = _build.library().repro_spike_gather(
        activity.data_ptr(), cols.data_ptr(), weights.data_ptr(),
        out.data_ptr(), R, K, stream, device,
    )
    _build.check(rc, "spike_gather")
    COUNTER.launches += 1
    return out

