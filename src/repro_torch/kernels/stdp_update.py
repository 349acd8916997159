"""Pair STDP over ELL panels: the CUDA kernels of ``csrc/stdp_update.cu``
and their plain versions.

Counterpart of ``repro/kernels/stdp_update.py:stdp_update_pallas``, in two
forms:

  * :func:`stdp_update_cuda` (``ops.stdp_update``) -- one panel, every
    slot, the reference op's signature.  It takes an optional ``out``,
    which may be ``weights`` itself: the update is then in place.  It takes
    f32 or bf16 weights and gives the new weights in that type; bf16 is
    rounded at every operation, as ``stdp_update_pallas`` rounds it.
  * :func:`stdp_update_step_cuda` (``ops.stdp_update_step``) -- the
    unfused engine's form: every delay bucket of a step in one launch (one
    a group of :data:`STEP_MAX_BUCKETS` buckets), f32 weights updated in
    place, only the rows and slots that :class:`StdpStepPlan` (made once
    at upload by :func:`stdp_step_plan`) lists, the post terms of each row
    (0 past ``n_p``, a split bucket's through its ``row_map``) read in the
    kernel.  Its weights equal the reference's per-bucket loop
    (:func:`stdp_update_step_plain`) bit for bit.

The ``*_cuda`` wrappers launch on CUDA tensors and raise on any other; the
ops take the plain versions only for CPU tensors.

Precondition of the kernels: every col id lies in ``[0, len(pre_trace))``.
The simulator checks it on the host when it builds the panels.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .ref import stdp_update_ref

# both forms count here: row 10 of PERF.md's kernel table
COUNTER = _build.LaunchCounter("stdp_update")

# buckets a launch of the engine form takes (csrc/stdp_update.cu:kMaxBuckets)
STEP_MAX_BUCKETS = 32

__all__ = [
    "COUNTER", "STEP_MAX_BUCKETS", "StdpStepPlan", "stdp_step_plan", "stdp_update_cuda",
    "stdp_update_plain", "stdp_update_step_cuda", "stdp_update_step_plain",
]


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


# -- the engine form: every bucket of a step ---------------------------------

@dataclasses.dataclass(frozen=True)
class StdpStepPlan:
    """The work of :func:`stdp_update_step_cuda` over one partition's
    panels, made at upload (the masks, row lengths and row maps never
    change)."""

    # (n_items, 4) int32: per (bucket, row) holding a plastic slot, the
    # bucket's index in its launch group, the row, its real slots and the
    # row whose post terms it takes (-1: none, 0); bucket-major
    items: torch.Tensor
    groups: Tuple[Tuple[int, int], ...]  # per launch group, its items' range
    shapes: Tuple[Tuple[int, int], ...]  # per bucket the panel's (R, K)
    n_p: int
    # per bucket its (R,) virtual row -> real row map (a split bucket), or
    # None (rows >= n_p take 0): the plain version's post terms
    row_map: Tuple[Optional[torch.Tensor], ...]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def stdp_step_plan(plastic, row_len, row_map, n_p: int, device) -> StdpStepPlan:
    """The plan of a partition's panels: per bucket its ``(R, K)`` plastic
    mask, its ``(R,)`` real slots a row (the ELL puts them first) and its
    ``(R,)`` row map or None (``row_map`` itself may be None: no bucket is
    split).  Raises where a plastic slot lies past its row's real slots
    (the kernel reads only those) or a row map leaves ``[0, n_p)``."""
    nd = len(plastic)
    row_map = [None] * nd if row_map is None else list(row_map)
    if len(row_len) != nd or len(row_map) != nd:
        raise ValueError(f"{nd} masks, {len(row_len)} row_len and {len(row_map)} row_map entries")
    parts, shapes = [], []
    for b in range(nd):
        m, rl = _host(plastic[b]), _host(row_len[b]).astype(np.int64)
        R, K = m.shape
        if rl.shape != (R,):
            raise ValueError(f"row_len[{b}] {rl.shape} for a panel of {R} rows")
        plastic_slot = m > 0
        real = np.arange(K)[None, :] < rl[:, None]
        if np.any(plastic_slot & ~real):
            raise ValueError(f"bucket {b} has a plastic slot past its row's real slots")
        rows = np.flatnonzero(plastic_slot.any(axis=1)).astype(np.int64)
        if row_map[b] is None:
            post = np.where(rows < n_p, rows, -1)
        else:
            rm = _host(row_map[b]).astype(np.int64)
            if rm.shape != (R,):
                raise ValueError(f"row_map[{b}] {rm.shape} for a panel of {R} rows")
            post = rm[rows]
            if post.size and not (0 <= post.min() and post.max() < n_p):
                raise ValueError(f"row_map[{b}] maps a plastic row outside [0, {n_p})")
        parts.append(np.stack([np.full_like(rows, b % STEP_MAX_BUCKETS), rows, rl[rows], post],
                              axis=1))
        shapes.append((R, K))
    S = STEP_MAX_BUCKETS
    bounds = np.cumsum([0] + [sum(len(p) for p in parts[g:g + S]) for g in range(0, nd, S)])
    return StdpStepPlan(
        items=torch.from_numpy(np.concatenate(parts).astype(np.int32)).to(device),
        groups=tuple(zip(bounds[:-1].tolist(), bounds[1:].tolist())),
        shapes=tuple(shapes),
        n_p=int(n_p),
        row_map=tuple(None if r is None else torch.as_tensor(_host(r).astype(np.int64)).to(device)
                      for r in row_map),
    )


def stdp_update_step_plain(
    weights, plastic, cols, pre_trace, pre_spike, post_trace, post_spike, *,
    plan: StdpStepPlan, params: Dict[str, float],
):
    """The reference's per-bucket loop: ``stdp_update_ref`` a bucket, with
    the ``(n_p,)`` post terms padded to the bucket's rows (0 past ``n_p``)
    or taken through its row map, written into ``weights``, which it
    returns."""
    padded = {}
    for b, (w, m, c) in enumerate(zip(weights, plastic, cols)):
        rm = plan.row_map[b]
        if rm is not None:
            post_t, post_s = (x.index_select(0, rm) for x in (post_trace, post_spike))
        else:
            R = w.shape[0]
            if R not in padded:
                padded[R] = tuple(torch.nn.functional.pad(x, (0, R - plan.n_p))
                                  for x in (post_trace, post_spike))
            post_t, post_s = padded[R]
        stdp_update_plain(w, m, c, pre_trace, pre_spike, post_t, post_s, params=params, out=w)
    return weights


def stdp_update_step_cuda(
    weights: Sequence[torch.Tensor],
    plastic: Sequence[torch.Tensor],
    cols: Sequence[torch.Tensor],
    pre_trace: torch.Tensor,
    pre_spike: torch.Tensor,
    post_trace: torch.Tensor,
    post_spike: torch.Tensor,
    *,
    plan: StdpStepPlan,
    params: Dict[str, float],
):
    """Launch the engine form: the ``plan``'s rows of every bucket updated
    in place in ``weights`` (f32 panels, which it returns), one launch a
    group of :data:`STEP_MAX_BUCKETS` buckets that holds a plastic row.
    ``plastic`` (f32 masks) and ``cols`` (int32) are the panels the plan
    was made from; ``pre_trace`` and ``pre_spike`` ``(n,)``,
    ``post_trace`` and ``post_spike`` ``(n_p,)``, all f32."""
    nd = len(weights)
    if not (len(plastic) == len(cols) == len(plan.shapes) == nd) or nd == 0:
        raise ValueError(f"{nd} weight, {len(plastic)} mask and {len(cols)} col panels for a "
                         f"plan of {len(plan.shapes)} buckets")
    _build.require_plastic_f32("stdp_update_step", weights)
    dev = weights[0].device
    for b, (w, m, c, shape) in enumerate(zip(weights, plastic, cols, plan.shapes)):
        _build.require(f"weights[{b}]", w, torch.float32, 2, dev)
        _build.require(f"plastic[{b}]", m, torch.float32, 2, dev)
        _build.require(f"cols[{b}]", c, torch.int32, 2, dev)
        if not w.shape == m.shape == c.shape == shape:
            raise ValueError(f"bucket {b}: weights {tuple(w.shape)}, plastic {tuple(m.shape)}, "
                             f"cols {tuple(c.shape)}, plan {shape}")
    _build.require("pre_trace", pre_trace, torch.float32, 1, dev)
    n = pre_trace.shape[0]
    for name, t, size in (("pre_spike", pre_spike, n),
                          ("post_trace", post_trace, plan.n_p),
                          ("post_spike", post_spike, plan.n_p)):
        _build.require(name, t, torch.float32, 1, dev)
        if t.shape[0] != size:
            raise ValueError(f"{name}: {t.shape[0]} entries, expected {size}")
    _build.require("plan.items", plan.items, torch.int32, 2, dev)
    lib = _build.library()
    stream, device = _build.launch_args(weights[0])
    for g, (lo, hi) in enumerate(plan.groups):
        if hi == lo:
            continue  # no plastic row in the group
        bs = range(g * STEP_MAX_BUCKETS, min(nd, (g + 1) * STEP_MAX_BUCKETS))
        ptrs = ctypes.c_void_p * len(bs)
        rc = lib.repro_stdp_update_step(
            plan.items[lo].data_ptr(), hi - lo, pre_trace.data_ptr(), pre_spike.data_ptr(),
            post_trace.data_ptr(), post_spike.data_ptr(), len(bs),
            ptrs(*[cols[b].data_ptr() for b in bs]), ptrs(*[weights[b].data_ptr() for b in bs]),
            ptrs(*[plastic[b].data_ptr() for b in bs]),
            (ctypes.c_int * len(bs))(*[plan.shapes[b][1] for b in bs]),
            params["a_plus"], params["a_minus"], params["w_min"], params["w_max"],
            stream, device,
        )
        _build.check(rc, "stdp_update_step")
        COUNTER.launches += 1
    return weights
