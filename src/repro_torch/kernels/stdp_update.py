"""Pair STDP over one ELL panel: the CUDA kernel ``csrc/stdp_update.cu`` and
its plain version.

Counterpart of ``repro/kernels/stdp_update.py:stdp_update_pallas``.
:func:`stdp_update_cuda` launches the kernel on CUDA tensors and raises on
any other; ``ops.stdp_update`` takes the plain version
(:func:`stdp_update_plain`) only for CPU tensors.  Both take an optional
``out``, which may be ``weights`` itself: the update is then in place.
Both take f32 or bf16 weights and give the new weights in that type; bf16
is rounded at every operation, as ``stdp_update_pallas`` rounds it.

Precondition of the kernel: every col id lies in ``[0, len(pre_trace))``.
The simulator checks it on the host when it builds the panels.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import _build
from .ref import stdp_update_ref

COUNTER = _build.LaunchCounter("stdp_update")

__all__ = ["COUNTER", "stdp_update_cuda", "stdp_update_plain"]


def stdp_update_plain(
    weights, valid, cols, pre_trace, pre_spike, post_trace, post_spike, *,
    params: Dict[str, float], out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``ref.stdp_update_ref``, written into ``out`` when one is given."""
    w = stdp_update_ref(
        weights, valid, cols, pre_trace, pre_spike, post_trace, post_spike,
        a_plus=params["a_plus"], a_minus=params["a_minus"],
        w_min=params["w_min"], w_max=params["w_max"],
    )
    return w if out is None else out.copy_(w)


def _bf16(x: float) -> float:
    """``x`` rounded to bf16 (round to nearest even), as an f32 value."""
    return float(torch.tensor(x, dtype=torch.bfloat16))


def stdp_update_cuda(
    weights: torch.Tensor,
    valid: torch.Tensor,
    cols: torch.Tensor,
    pre_trace: torch.Tensor,
    pre_spike: torch.Tensor,
    post_trace: torch.Tensor,
    post_spike: torch.Tensor,
    *,
    params: Dict[str, float],
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the kernel: the ``(R, K)`` new weights in the weights' type
    (f32 or bf16), in ``out`` when one is given (``out`` may be
    ``weights``).  The mask is f32, or bf16 with bf16 weights; the four
    vectors are f32 (rounded to bf16 in the kernel with bf16 weights)."""
    w_bf16 = _build.require_weights("weights", weights, None)
    dev = weights.device
    _build.require_panel("valid", valid, valid.dtype, dev,
                         (torch.float32, weights.dtype))
    _build.require("cols", cols, torch.int32, 2, dev)
    if not weights.shape == valid.shape == cols.shape:
        raise ValueError(
            f"weights {tuple(weights.shape)}, valid {tuple(valid.shape)} and "
            f"cols {tuple(cols.shape)} differ"
        )
    R, K = weights.shape
    for name, t, n in (("pre_trace", pre_trace, None), ("pre_spike", pre_spike, None),
                       ("post_trace", post_trace, R), ("post_spike", post_spike, R)):
        _build.require(name, t, torch.float32, 1, dev)
        if n is not None and t.shape[0] != n:
            raise ValueError(f"{name}: {t.shape[0]} entries for {n} rows")
    if pre_spike.shape != pre_trace.shape:
        raise ValueError(
            f"pre_spike {tuple(pre_spike.shape)} != pre_trace {tuple(pre_trace.shape)}"
        )
    if out is None:
        out = torch.empty_like(weights)
    else:
        _build.require("out", out, weights.dtype, 2, dev)
        if out.shape != weights.shape:
            raise ValueError(f"out {tuple(out.shape)} != weights {tuple(weights.shape)}")
    if R == 0 or K == 0:
        return out
    scalars = [params[k] for k in ("a_plus", "a_minus", "w_min", "w_max")]
    if w_bf16:
        scalars = [_bf16(x) for x in scalars]
    stream, device = _build.launch_args(weights)
    rc = _build.library().repro_stdp_update(
        weights.data_ptr(), valid.data_ptr(), cols.data_ptr(),
        pre_trace.data_ptr(), pre_spike.data_ptr(),
        post_trace.data_ptr(), post_spike.data_ptr(), out.data_ptr(), R, K,
        w_bf16, int(valid.dtype == torch.bfloat16), *scalars, stream, device,
    )
    _build.check(rc, "stdp_update")
    COUNTER.launches += 1
    return out
