"""Fused k=1 LIF step: the cooperative CUDA kernel ``csrc/fused_step.cu``
and its plain version.

Counterpart of ``repro/kernels/fused_step.py:fused_lif_step_pallas``: one
launch advances every neuron, emits the spike vector and gathers every
delay bucket from it.  :func:`fused_step_cuda` launches the kernel on CUDA
tensors and raises on any other; ``ops.fused_step`` takes the plain version
(:func:`fused_step_plain`, i.e. ``ref.fused_step_ref``) only for CPU
tensors.

Preconditions: all buckets share R >= n_p, and every col id is a local id
(< n_p; the exchange is the identity at k=1).  The simulator checks the col
range on the host when it builds the panels.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from . import _build
from .ref import fused_step_ref as fused_step_plain, lif_constants

COUNTER = _build.LaunchCounter("fused_step")

# size of the kernel's per-bucket argument table (csrc/fused_step.cu)
MAX_BUCKETS = 32

__all__ = [
    "COUNTER", "MAX_BUCKETS", "fused_step_cuda",
    "fused_step_plain",
]


def fused_step_cuda(
    v: torch.Tensor,
    refrac: torch.Tensor,
    i_tot: torch.Tensor,
    cols: Sequence[torch.Tensor],
    weights: Sequence[torch.Tensor],
    *,
    params: Dict[str, float],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """Launch the kernel: ``(v', refrac', spikes, currents)`` with the
    state vectors ``(n_p,)`` and ``currents[i]`` of shape ``(R,)``."""
    nd = len(cols)
    if not 1 <= nd <= MAX_BUCKETS or len(weights) != nd:
        raise ValueError(
            f"fused_step takes 1..{MAX_BUCKETS} delay buckets with one weight "
            f"panel each, got {nd} col and {len(weights)} weight panels"
        )
    _build.require("v", v, torch.float32, 1)
    dev = v.device
    for name, t in (("refrac", refrac), ("i_tot", i_tot)):
        _build.require(name, t, torch.float32, 1, dev)
        if t.shape != v.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != v's {tuple(v.shape)}")
    n_p = v.shape[0]
    R = cols[0].shape[0]
    for i, (c, w) in enumerate(zip(cols, weights)):
        _build.require(f"cols[{i}]", c, torch.int32, 2, dev)
        _build.require(f"weights[{i}]", w, torch.float32, 2, dev)
        if c.shape != w.shape or c.shape[0] != R or c.shape[1] < 1:
            raise ValueError(
                "fused_step needs (R, K_d) col/weight panels with a common R "
                f"and K_d >= 1: {[tuple(c.shape) for c in cols]} vs "
                f"{[tuple(w.shape) for w in weights]}"
            )
    if R < n_p:
        raise ValueError(f"panels have R={R} rows for n_p={n_p} neurons")
    v_out, r_out, s_out = (torch.empty_like(v) for _ in range(3))
    currents = [torch.empty(R, dtype=torch.float32, device=dev) for _ in cols]
    if n_p == 0:
        return v_out, r_out, s_out, [c.zero_() for c in currents]
    ptrs = ctypes.c_void_p * nd
    decay, ref_steps = lif_constants(params["dt"], params["tau_m"], params["t_ref"])
    stream, device = _build.launch_args(v)
    rc = _build.library().repro_fused_step(
        v.data_ptr(), refrac.data_ptr(), i_tot.data_ptr(),
        v_out.data_ptr(), r_out.data_ptr(), s_out.data_ptr(),
        n_p, R, nd,
        ptrs(*[c.data_ptr() for c in cols]),
        ptrs(*[w.data_ptr() for w in weights]),
        (ctypes.c_int * nd)(*[c.shape[1] for c in cols]),
        ptrs(*[c.data_ptr() for c in currents]),
        params["v_rest"], params["v_reset"], params["v_thresh"],
        decay, 1.0 - decay, params["r_m"], ref_steps, stream, device,
    )
    _build.check(rc, "fused_step")
    COUNTER.launches += 1
    return v_out, r_out, s_out, currents

