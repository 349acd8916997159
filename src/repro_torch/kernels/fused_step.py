"""Fused k=1 LIF steps: the cooperative CUDA kernels ``csrc/fused_step.cu``
and ``csrc/fused_plastic_step.cu``, with their plain versions.

Counterparts of ``repro/kernels/fused_step.py:fused_lif_step_pallas`` and
``:fused_plastic_step_pallas``: one launch advances every neuron, emits the
spike vector and gathers every delay bucket from it; the plastic variant
also decays both e-traces and writes every bucket's STDP update, from the
weights the gather read.  :func:`fused_step_cuda` and
:func:`fused_step_plastic_cuda` launch the kernels on CUDA tensors and raise
on any other; ``ops.fused_step`` and ``ops.fused_step_plastic`` take the
plain versions (:func:`fused_step_plain`, :func:`fused_step_plastic_plain`,
i.e. ``ref.fused_step_ref`` and ``ref.fused_step_plastic_ref``) only for CPU
tensors.

Weights: ``fused_step`` takes f32 or bf16 panels (all buckets one type),
widened exactly and summed in f32 as the reference's kernel
(``fused_step.py:101``); the plastic kernel takes f32.

Preconditions: all buckets share R >= n_p, and every col id is a local id
(< n_p; the exchange is the identity at k=1).  The simulator checks the col
range on the host when it builds the panels.

``fused_step`` packs the step's spikes into a bitmask and gathers each row's
first ``row_len[r]`` slots, loading a weight only where its source spiked
(``csrc/common.cuh:row_dot_active``); it equals the ``row_dot`` reduction of
every slot bit for bit when the weights are finite.  It runs where
``reduce`` is the choice recorded from the weights
(``dispatch.panel_reduce``: ``active`` only where they are all finite);
otherwise the kernel's row_dot variant runs, whose NaN rows are the
reference's.  ``reduce="row_dot"``, the default, is the bit-exact oracle
on the card.  The plastic kernel reads each row's first ``row_len[r]``
slots once (their weights change every step, so every real slot is read;
the padding past ``row_len`` adds nothing and keeps its weight, as
``csrc/common.cuh:plastic_row`` argues), writes the new weights in place
into ``weights_out`` (only plastic slots whose bits change), and in its
ring form adds each bucket's currents into ``ring[(t + d) % D]`` in the
same launch, as the engine's step needs.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import _build
from .dispatch import launch_row_dot
from .ref import (
    fused_step_plastic_ref as fused_step_plastic_plain,
    fused_step_ref as fused_step_plain,
    lif_constants,
    trace_decay_constant,
)

COUNTER = _build.LaunchCounter("fused_step")
PLASTIC_COUNTER = _build.LaunchCounter("fused_plastic_step")

# size of the kernel's per-bucket argument table (csrc/fused_step.cu)
MAX_BUCKETS = 32

__all__ = [
    "COUNTER", "MAX_BUCKETS", "PLASTIC_COUNTER", "fused_step_cuda",
    "fused_step_plain", "fused_step_plastic_cuda", "fused_step_plastic_plain",
]


def _check_operands(
    what: str,
    v: torch.Tensor,
    vectors: Dict[str, torch.Tensor],
    cols: Sequence[torch.Tensor],
    panels: Dict[str, Sequence[torch.Tensor]],
    panel_dtypes: Optional[Dict[str, Tuple[torch.dtype, ...]]] = None,
) -> Tuple[int, int]:
    """Validate the state vectors (``v`` and ``vectors``, all ``(n_p,)``
    f32) and the per-bucket panels (``cols`` int32, each of ``panels`` f32,
    or one of the types ``panel_dtypes`` allows it, the same in every
    bucket, all ``(R, K_d)`` with a common R >= n_p); returns ``(n_p,
    R)``."""
    nd = len(cols)
    if not 1 <= nd <= MAX_BUCKETS or any(len(p) != nd for p in panels.values()):
        raise ValueError(
            f"{what} takes 1..{MAX_BUCKETS} delay buckets with one panel of each "
            f"kind, got {nd} col panels and "
            + ", ".join(f"{len(p)} {name}" for name, p in panels.items())
        )
    _build.require("v", v, torch.float32, 1)
    dev = v.device
    for name, t in vectors.items():
        _build.require(name, t, torch.float32, 1, dev)
        if t.shape != v.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != v's {tuple(v.shape)}")
    R = cols[0].shape[0]
    for i, c in enumerate(cols):
        _build.require(f"cols[{i}]", c, torch.int32, 2, dev)
        for name, p in panels.items():
            _build.require_panel(f"{name}[{i}]", p[i], p[0].dtype, dev,
                                 (panel_dtypes or {}).get(name))
        if any(p[i].shape != c.shape for p in panels.values()) or c.shape[0] != R \
                or c.shape[1] < 1:
            raise ValueError(
                f"{what} needs (R, K_d) panels of one shape per bucket, with a "
                f"common R and K_d >= 1: cols {[tuple(c.shape) for c in cols]}, "
                + ", ".join(f"{name} {[tuple(x.shape) for x in p]}"
                            for name, p in panels.items())
            )
    n_p = v.shape[0]
    if R < n_p:
        raise ValueError(f"panels have R={R} rows for n_p={n_p} neurons")
    return n_p, R


def fused_step_cuda(
    v: torch.Tensor,
    refrac: torch.Tensor,
    i_tot: torch.Tensor,
    cols: Sequence[torch.Tensor],
    weights: Sequence[torch.Tensor],
    row_len: Optional[Sequence[torch.Tensor]] = None,
    *,
    params: Dict[str, float],
    reduce="row_dot",
    shared_bitmask: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """Launch the kernel: ``(v', refrac', spikes, currents)`` with the
    state vectors ``(n_p,)`` and ``currents[i]`` of shape ``(R,)`` (f32;
    the weights are f32 or bf16, one type for every bucket).
    ``row_len``: per bucket ``(R,)`` int32 real slots a row, or None (rows
    K long).  ``reduce``: ``"row_dot"`` or per bucket the recorded
    choice (``dispatch.launch_row_dot``).
    ``shared_bitmask=False`` reads the bitmask from L2, the path of more
    neurons than shared memory holds bits for (for tests and timing)."""
    n_p, R = _check_operands(
        "fused_step", v, dict(refrac=refrac, i_tot=i_tot), cols, dict(weights=weights),
        dict(weights=_build.GATHER_WEIGHT_DTYPES),
    )
    nd = len(cols)
    _build.check_row_len(row_len, nd, R, v.device)
    v_out, r_out, s_out = (torch.empty_like(v) for _ in range(3))
    currents = [torch.empty(R, dtype=torch.float32, device=v.device) for _ in cols]
    if n_p == 0:
        return v_out, r_out, s_out, [c.zero_() for c in currents]
    dense = launch_row_dot(reduce, weights)
    bits = torch.empty(0 if dense else -(-n_p // 32), dtype=torch.int32, device=v.device)
    ptrs = ctypes.c_void_p * nd
    decay, ref_steps = lif_constants(params["dt"], params["tau_m"], params["t_ref"])
    stream, device = _build.launch_args(v)
    rc = _build.library().repro_fused_step(
        v.data_ptr(), refrac.data_ptr(), i_tot.data_ptr(),
        v_out.data_ptr(), r_out.data_ptr(), s_out.data_ptr(),
        n_p, R, nd,
        ptrs(*[c.data_ptr() for c in cols]),
        ptrs(*[w.data_ptr() for w in weights]), int(weights[0].dtype == torch.bfloat16),
        ptrs(*([None] * nd if row_len is None else [rl.data_ptr() for rl in row_len])),
        (ctypes.c_int * nd)(*[c.shape[1] for c in cols]),
        ptrs(*[c.data_ptr() for c in currents]),
        bits.data_ptr(), -1 if shared_bitmask else 0, int(dense),
        params["v_rest"], params["v_reset"], params["v_thresh"],
        decay, 1.0 - decay, params["r_m"], ref_steps, stream, device,
    )
    _build.check(rc, "fused_step")
    COUNTER.launches += 1
    return v_out, r_out, s_out, currents


def _check_ring(ring, t, delays, nd: int, n_p: int, device) -> Tuple[torch.Tensor, List[int]]:
    """Validate the ring form's operands: a ``(D, n_p)`` f32 ring on
    ``device``, the step ``t`` and one delay a bucket, no two the same modulo
    ``D`` (each ring element takes one add a launch).  Returns the step as
    the kernel reads it and each bucket's ring offset ``d % D``."""
    _build.require("ring", ring, torch.float32, 2, device)
    D = ring.shape[0]
    if ring.shape[1] != n_p or D < 1:
        raise ValueError(f"ring {tuple(ring.shape)} for n_p={n_p} neurons")
    if delays is None or len(delays) != nd:
        raise ValueError(f"the ring form takes one delay a bucket: {nd} buckets, delays "
                         f"{delays}")
    offsets = [int(d) % D for d in delays]
    if len(set(offsets)) != nd:
        raise ValueError(f"delays {tuple(delays)} share a ring slot modulo D={D}: the "
                         "kernel adds every bucket's rows in parallel")
    if t is None:
        raise ValueError("the ring form needs the step t")
    return _build.step_tensor(t, device), offsets


def fused_step_plastic_cuda(
    v: torch.Tensor,
    refrac: torch.Tensor,
    i_tot: torch.Tensor,
    tr_plus: torch.Tensor,
    tr_minus: torch.Tensor,
    cols: Sequence[torch.Tensor],
    weights: Sequence[torch.Tensor],
    plastic: Sequence[torch.Tensor],
    row_len: Optional[Sequence[torch.Tensor]] = None,
    *,
    params: Dict[str, float],
    taus: Tuple[float, float],
    stdp: Dict[str, float],
    ring: Optional[torch.Tensor] = None,
    t=None,
    delays: Optional[Sequence[int]] = None,
    weights_out: Optional[Sequence[torch.Tensor]] = None,
):
    """Launch the plastic kernel: ``(v', refrac', spikes, tr_plus',
    tr_minus', currents, new_weights)`` with the vectors ``(n_p,)`` and
    ``currents[i]`` of shape ``(R,)``.  ``row_len``: per bucket ``(R,)``
    int32 real slots a row (the ELL layout: real slots first, ``(col 0,
    weight +0, mask 0)`` after), or None (rows K long).  The ring form
    (``ring``, a ``(D, n_p)`` f32 tensor, with the step ``t``, an int or
    the 0-d int64 step on the card, and one delay a bucket, no two the same
    modulo ``D``) adds each bucket's currents of rows ``< n_p`` into
    ``ring[(t + d) % D]`` in the launch, one f32 add an element, and
    returns the ring in the currents' place.  The new weights go into
    ``weights_out`` (which may be ``weights``: in place) or into new copies
    of the panels; only plastic slots whose bits change are written."""
    _build.require_plastic_f32("fused_step_plastic", weights)
    n_p, R = _check_operands(
        "fused_step_plastic", v,
        dict(refrac=refrac, i_tot=i_tot, tr_plus=tr_plus, tr_minus=tr_minus),
        cols, dict(weights=weights, plastic=plastic),
    )
    nd = len(cols)
    dev = v.device
    _build.check_row_len(row_len, nd, R, dev)
    t_dev, offsets = (None, None) if ring is None else _check_ring(ring, t, delays, nd, n_p, dev)
    new_weights = _build.plastic_weights_out(weights, weights_out)
    outs = [torch.empty_like(v) for _ in range(5)]
    currents = None if ring is not None else [
        torch.empty(R, dtype=torch.float32, device=dev) for _ in cols]
    if n_p == 0:
        return (*outs, ring if currents is None else [c.zero_() for c in currents], new_weights)
    ptrs = ctypes.c_void_p * nd
    ints = ctypes.c_int * nd
    decay, ref_steps = lif_constants(params["dt"], params["tau_m"], params["t_ref"])
    stream, device = _build.launch_args(v)
    rc = _build.library().repro_fused_plastic_step(
        v.data_ptr(), refrac.data_ptr(), i_tot.data_ptr(),
        tr_plus.data_ptr(), tr_minus.data_ptr(), *[o.data_ptr() for o in outs],
        n_p, R, nd,
        ptrs(*[c.data_ptr() for c in cols]),
        ptrs(*[w.data_ptr() for w in new_weights]),
        ptrs(*[p.data_ptr() for p in plastic]),
        ptrs(*([None] * nd if row_len is None else [rl.data_ptr() for rl in row_len])),
        ints(*[c.shape[1] for c in cols]),
        None if currents is None else ptrs(*[c.data_ptr() for c in currents]),
        None if ring is None else ring.data_ptr(), None if t_dev is None else t_dev.data_ptr(),
        0 if ring is None else ring.shape[0], None if offsets is None else ints(*offsets),
        params["v_rest"], params["v_reset"], params["v_thresh"],
        decay, 1.0 - decay, params["r_m"], ref_steps,
        trace_decay_constant(params["dt"], taus[0]),
        trace_decay_constant(params["dt"], taus[1]),
        stdp["a_plus"], stdp["a_minus"], stdp["w_min"], stdp["w_max"],
        stream, device,
    )
    _build.check(rc, "fused_step_plastic")
    PLASTIC_COUNTER.launches += 1
    return (*outs, ring if currents is None else currents, new_weights)
