"""LIF advance: the CUDA kernel ``csrc/lif_step.cu`` and its plain version.

Counterpart of ``repro/kernels/lif_step.py:lif_step_pallas``.
:func:`lif_step_cuda` launches the kernel on CUDA tensors and raises on any
other; ``ops.lif_step`` takes the plain version (:func:`lif_step_plain`,
i.e. ``ref.lif_step_ref``) only for CPU tensors.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import _build
from .ref import lif_constants, lif_step_ref as lif_step_plain

COUNTER = _build.LaunchCounter("lif_step")

__all__ = ["COUNTER", "lif_step_cuda", "lif_step_plain"]


def lif_step_cuda(
    v: torch.Tensor, refrac: torch.Tensor, i_syn: torch.Tensor, *,
    params: Dict[str, float],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel: ``(v', refrac', spike)``, all ``(n,)`` f32."""
    _build.require("v", v, torch.float32, 1)
    for name, t in (("refrac", refrac), ("i_syn", i_syn)):
        _build.require(name, t, torch.float32, 1, v.device)
        if t.shape != v.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != v's {tuple(v.shape)}")
    n = v.shape[0]
    v_out, r_out, s_out = (torch.empty_like(v) for _ in range(3))
    if n == 0:
        return v_out, r_out, s_out
    decay, ref_steps = lif_constants(params["dt"], params["tau_m"], params["t_ref"])
    stream, device = _build.launch_args(v)
    rc = _build.library().repro_lif_step(
        v.data_ptr(), refrac.data_ptr(), i_syn.data_ptr(),
        v_out.data_ptr(), r_out.data_ptr(), s_out.data_ptr(), n,
        params["v_rest"], params["v_reset"], params["v_thresh"],
        decay, 1.0 - decay, params["r_m"], ref_steps, stream, device,
    )
    _build.check(rc, "lif_step")
    COUNTER.launches += 1
    return v_out, r_out, s_out

