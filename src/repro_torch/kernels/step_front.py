"""The step front: the CUDA kernel ``csrc/step_front.cu`` and its plain
version.

Counterpart of ``repro/kernels/lif_step.py:lif_step_pallas`` (without
traces) and ``repro/kernels/fused_step.py:fused_pre_exchange_pallas`` (with
them), together with the jnp the reference runs around them: the noise, the
bias and the history row.  One launch per partition and step draws the
noise at the partition's ids and adds it to the delivered ring slot, read in
place, adds the bias column of ``vtx_state``, advances LIF in place in
``vtx_state``'s ``v`` and ``refrac`` columns, writes the spike vector and
the history row ``hist[t % D]``, and, with traces, both decayed traces as
new tensors.  The step ``t`` may be the simulator's 0-d int64 tensor on the
card: the kernel reads it, and picks the delivered row ``t % D`` of the
``(D, n)`` ring and the history row ``t % D`` of the ``(D, n)`` hist itself,
so one captured launch serves every step of a chunk.  Bit for bit the
chain it replaces on the split and event engines (``noise_add``, two
``contiguous()`` copies, ``lif_step`` or ``pre_exchange``, two column
writes, the uint8 history write).

:func:`step_front_cuda` launches the kernel for CUDA tensors and raises for
any other; ``ops.step_front`` takes the plain version
(:func:`step_front_plain`, i.e. ``ref.step_front_ref``) only for CPU
tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import _build
from .noise import check_operands
from .ref import LIF_COLUMNS, lif_constants, trace_decay_constant
from .ref import step_front_ref as step_front_plain

COUNTER = _build.LaunchCounter("step_front")

__all__ = ["COUNTER", "step_front_cuda", "step_front_plain"]


def _require_vec(name: str, t: torch.Tensor, dtype: torch.dtype, n: int, device) -> None:
    _build.require(name, t, dtype, 1, device)
    if t.shape[0] != n:
        raise ValueError(f"{name}: {tuple(t.shape)} for {n} rows")


def _require_rows(name: str, t: torch.Tensor, dtype: torch.dtype, n: int, device) -> int:
    """Check an ``(n,)`` row or a ``(D, n)`` ring of rows; returns its row
    count (1 for a single row)."""
    if t.dim() == 1:
        _require_vec(name, t, dtype, n, device)
        return 1
    _build.require(name, t, dtype, 2, device)
    if t.shape[1] != n or t.shape[0] < 1:
        raise ValueError(f"{name}: {tuple(t.shape)} for {n} rows")
    return t.shape[0]


def step_front_cuda(
    vtx: torch.Tensor,
    slot: torch.Tensor,
    ids: Optional[torch.Tensor],
    *,
    seed: int,
    t,
    sigma: float,
    draw: bool,
    bias: bool,
    hist_row: Optional[torch.Tensor],
    tr_plus: Optional[torch.Tensor] = None,
    tr_minus: Optional[torch.Tensor] = None,
    params: Dict[str, float],
    taus: Optional[Tuple[float, float]] = None,
) -> Tuple[torch.Tensor, ...]:
    """Launch the kernel on ``vtx``'s card: ``vtx`` is the contiguous ``(n,
    ld)`` f32 LIF ``vtx_state`` (``ld >= 3``; ``v`` and ``refrac`` are
    written in place), ``slot`` the contiguous ``(n,)`` f32 delivered ring
    slot or the ``(D, n)`` ring whose row ``t % D`` is delivered, ``ids``
    the ``(n,)`` int64 permanent ids (needed with ``draw``), ``hist_row`` a
    contiguous ``(n,)`` uint8 row or ``(D, n)`` history (row ``t % D``)
    written in place, or None.  ``t`` is an int or a 0-d int64 tensor on the
    card, read there when the launch runs.
    ``tr_plus`` and ``tr_minus`` (both or neither, ``(n,)`` f32) take the
    trace variant, with ``taus``.  Returns ``(spikes,)`` or ``(spikes,
    tr_plus', tr_minus')``, new ``(n,)`` f32 tensors."""
    _build.require("vtx", vtx, torch.float32, 2)
    n, ld = vtx.shape
    if ld <= max(LIF_COLUMNS):
        raise ValueError(f"vtx: {tuple(vtx.shape)} has no LIF bias column {LIF_COLUMNS[2]}")
    device = vtx.device
    slot_rows = _require_rows("slot", slot, torch.float32, n, device)
    if ids is not None:
        _require_vec("ids", ids, torch.int64, n, device)
    if draw:
        if ids is None:
            raise ValueError("the noise draw needs the partition's ids")
        check_operands(seed, t, n)
    hist_rows = 0
    if hist_row is not None:
        hist_rows = _require_rows("hist_row", hist_row, torch.uint8, n, device)
    traces = tr_plus is not None
    if traces != (tr_minus is not None) or (traces and taus is None):
        raise ValueError("the trace variant takes tr_plus, tr_minus and taus together")
    if traces:
        _require_vec("tr_plus", tr_plus, torch.float32, n, device)
        _require_vec("tr_minus", tr_minus, torch.float32, n, device)
    spikes = torch.empty(n, dtype=torch.float32, device=device)
    outs = (spikes, torch.empty_like(spikes), torch.empty_like(spikes)) if traces else (spikes,)
    if n == 0:
        return outs
    decay, ref_steps = lif_constants(params["dt"], params["tau_m"], params["t_ref"])
    d_plus, d_minus = ((trace_decay_constant(params["dt"], taus[0]),
                        trace_decay_constant(params["dt"], taus[1])) if traces else (0.0, 0.0))

    def ptr(x):
        return None if x is None else x.data_ptr()

    t_dev = _build.step_tensor(t, device)
    stream, index = _build.launch_args(vtx)
    rc = _build.library().repro_step_front(
        vtx.data_ptr(), ld, slot.data_ptr(), slot_rows, ptr(ids), spikes.data_ptr(),
        ptr(hist_row), max(hist_rows, 1), ptr(tr_plus), ptr(tr_minus),
        *(ptr(o) for o in outs[1:] or (None, None)), n,
        params["v_rest"], params["v_reset"], params["v_thresh"], decay, 1.0 - decay,
        params["r_m"], ref_steps, int(seed) & 0xFFFFFFFF, t_dev.data_ptr(), float(sigma),
        d_plus, d_minus, int(bool(draw)), int(bool(bias)), stream, index,
    )
    _build.check(rc, "step_front")
    COUNTER.launches += 1
    return outs
