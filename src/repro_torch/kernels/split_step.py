"""The split (k>1) step's kernels: ``csrc/pre_exchange.cu``,
``csrc/post_exchange.cu`` and ``csrc/post_exchange_plastic.cu``, with their
plain versions.

Counterparts of ``repro/kernels/fused_step.py``'s split kernels:

  * :func:`pre_exchange_cuda` -- ``fused_pre_exchange_pallas``, trace
    variant: LIF advance, spike emission and both trace decays (the
    trace-free variant is ``lif_step``, as in the reference);
  * :func:`post_exchange_cuda` -- ``fused_post_exchange_pallas`` and its
    ``_local`` and ``_remote`` wrappers: the ring rotate (``clear_mask``,
    or none for the remote pass) and every bucket's gather-accumulate;
  * :func:`post_exchange_plastic_cuda` --
    ``fused_post_exchange_plastic_pallas`` and
    ``fused_post_exchange_remote_plastic_pallas``: the same with the STDP
    update of every real slot (``row_len``), the new weights written in
    place into ``weights_out``; the gather reads ``act_gather`` (the full
    activity, or the remote pass's activity with the own slice zeroed,
    which the kernel can make itself from ``act`` and the slice's id range
    ``own``), the STDP update the full ``act`` and ``pre_trace``.

:func:`post_exchange_cuda` takes f32 or bf16 weight panels (one type for
every bucket of a launch), widened exactly and summed in f32 as the
reference's kernel does (``fused_step.py:528``); the plastic kernel takes
f32.

The ``*_cuda`` wrappers launch on CUDA tensors and raise on any other;
``ops.fused_pre_exchange`` and the ``ops.fused_post_exchange*`` entry points
take the plain versions of ``kernels/ref.py`` only for CPU tensors.  The
slot arithmetic arrives as device tensors (``clear_mask`` ``(D,)`` and
``write_onehot`` ``(nd, D)``), as in the reference, so nothing is read back
to the host.  Col ids are not range-checked here (the kernels read
``act[cols]`` unchecked); the simulator checks them when it builds the
panels.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import _build
from .dispatch import launch_row_dot
from .ref import lif_constants, trace_decay_constant

PRE_COUNTER = _build.LaunchCounter("pre_exchange")
POST_COUNTER = _build.LaunchCounter("post_exchange")
PLASTIC_COUNTER = _build.LaunchCounter("post_exchange_plastic")

# size of the post-exchange kernels' per-bucket argument tables
# (csrc/post_exchange.cu, csrc/post_exchange_plastic.cu: kMaxBuckets)
MAX_BUCKETS = 32

__all__ = [
    "MAX_BUCKETS", "PLASTIC_COUNTER", "POST_COUNTER", "PRE_COUNTER",
    "post_exchange_cuda", "post_exchange_plastic_cuda", "pre_exchange_cuda",
]


def pre_exchange_cuda(
    v: torch.Tensor,
    refrac: torch.Tensor,
    i_tot: torch.Tensor,
    tr_plus: torch.Tensor,
    tr_minus: torch.Tensor,
    *,
    params: Dict[str, float],
    taus: Tuple[float, float],
) -> Tuple[torch.Tensor, ...]:
    """Launch the trace variant: ``(v', refrac', spikes, tr_plus',
    tr_minus')``, all ``(n_p,)`` f32."""
    _build.require("v", v, torch.float32, 1)
    for name, t in (("refrac", refrac), ("i_tot", i_tot), ("tr_plus", tr_plus),
                    ("tr_minus", tr_minus)):
        _build.require(name, t, torch.float32, 1, v.device)
        if t.shape != v.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != v's {tuple(v.shape)}")
    n = v.shape[0]
    outs = [torch.empty_like(v) for _ in range(5)]
    if n == 0:
        return tuple(outs)
    decay, ref_steps = lif_constants(params["dt"], params["tau_m"], params["t_ref"])
    stream, device = _build.launch_args(v)
    rc = _build.library().repro_pre_exchange(
        v.data_ptr(), refrac.data_ptr(), i_tot.data_ptr(), tr_plus.data_ptr(),
        tr_minus.data_ptr(), *[o.data_ptr() for o in outs], n,
        params["v_rest"], params["v_reset"], params["v_thresh"],
        decay, 1.0 - decay, params["r_m"], ref_steps,
        trace_decay_constant(params["dt"], taus[0]),
        trace_decay_constant(params["dt"], taus[1]),
        stream, device,
    )
    _build.check(rc, "pre_exchange")
    PRE_COUNTER.launches += 1
    return tuple(outs)


def _check_post(
    what: str,
    acts: Dict[str, torch.Tensor],
    ring: torch.Tensor,
    clear_mask: Optional[torch.Tensor],
    write_onehot: torch.Tensor,
    cols: Sequence[torch.Tensor],
    panels: Dict[str, Sequence[torch.Tensor]],
    out: Optional[torch.Tensor],
    panel_dtypes: Optional[Dict[str, Tuple[torch.dtype, ...]]] = None,
) -> Tuple[int, int, int]:
    """Validate the operands of a post-exchange launch (each of ``panels``
    f32, or one of the types ``panel_dtypes`` allows it, the same in every
    bucket); returns ``(D, n_p, R)``."""
    nd = len(cols)
    if not 1 <= nd <= MAX_BUCKETS or any(len(p) != nd for p in panels.values()):
        raise ValueError(
            f"{what} takes 1..{MAX_BUCKETS} delay buckets with one panel of each "
            f"kind, got {nd} col panels and "
            + ", ".join(f"{len(p)} {name}" for name, p in panels.items())
        )
    _build.require("ring", ring, torch.float32, 2)
    dev = ring.device
    D, n_p = ring.shape
    for name, a in acts.items():
        _build.require(name, a, torch.float32, 1, dev)
    if clear_mask is not None:
        _build.require("clear_mask", clear_mask, torch.float32, 1, dev)
        if clear_mask.shape != (D,):
            raise ValueError(f"clear_mask {tuple(clear_mask.shape)} for a ring of {D} slots")
    _build.require("write_onehot", write_onehot, torch.float32, 2, dev)
    if write_onehot.shape != (nd, D):
        raise ValueError(
            f"write_onehot {tuple(write_onehot.shape)} for {nd} buckets and {D} slots"
        )
    if out is not None:
        _build.require("out", out, torch.float32, 2, dev)
        if out.shape != ring.shape:
            raise ValueError(f"out {tuple(out.shape)} != ring {tuple(ring.shape)}")
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
    if R < n_p:
        raise ValueError(f"panels have R={R} rows for a ring of n_p={n_p} neurons")
    return D, n_p, R


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def post_exchange_cuda(
    act: torch.Tensor,
    ring: torch.Tensor,
    clear_mask: Optional[torch.Tensor],
    write_onehot: torch.Tensor,
    cols: Sequence[torch.Tensor],
    weights: Sequence[torch.Tensor],
    row_len: Optional[Sequence[torch.Tensor]] = None,
    *,
    reduce="row_dot",
    shared_bitmask: bool = True,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the post-exchange kernel: ``ring * clear_mask`` (no rotate
    when ``clear_mask`` is None), then per bucket in order ``+
    write_onehot[i] (x) gather_i``.  Returns the new ring, written into
    ``out`` when given (``out`` may be ``ring``).  ``row_len``: per bucket
    ``(R,)`` int32 real slots a row, or None (rows K long).  ``reduce``:
    ``"row_dot"`` or per bucket the recorded choice
    (``dispatch.launch_row_dot``).  ``shared_bitmask=False`` tests the
    activity in device memory, the path of an activity too long for its
    bitmask to fit shared memory (for tests and timing)."""
    D, n_p, R = _check_post(
        "post_exchange", dict(act=act), ring, clear_mask, write_onehot, cols,
        dict(weights=weights), out, dict(weights=_build.GATHER_WEIGHT_DTYPES),
    )
    nd = len(cols)
    _build.check_row_len(row_len, nd, R, ring.device)
    out = torch.empty_like(ring) if out is None else out
    if n_p == 0:
        return out
    dense = launch_row_dot(reduce, weights)
    ptrs = ctypes.c_void_p * nd
    stream, device = _build.launch_args(ring)
    rc = _build.library().repro_post_exchange(
        act.data_ptr(), act.shape[0], ring.data_ptr(), out.data_ptr(), _ptr(clear_mask),
        write_onehot.data_ptr(), n_p, D, nd,
        ptrs(*[c.data_ptr() for c in cols]),
        ptrs(*[w.data_ptr() for w in weights]), int(weights[0].dtype == torch.bfloat16),
        ptrs(*([None] * nd if row_len is None else [rl.data_ptr() for rl in row_len])),
        (ctypes.c_int * nd)(*[c.shape[1] for c in cols]),
        -1 if shared_bitmask else 0, int(dense), stream, device,
    )
    _build.check(rc, "post_exchange")
    POST_COUNTER.launches += 1
    return out


def post_exchange_plastic_cuda(
    act_gather: Optional[torch.Tensor],
    act: torch.Tensor,
    pre_trace: torch.Tensor,
    ring: torch.Tensor,
    clear_mask: Optional[torch.Tensor],
    write_onehot: torch.Tensor,
    post_trace: torch.Tensor,
    post_spike: torch.Tensor,
    cols: Sequence[torch.Tensor],
    weights: Sequence[torch.Tensor],
    plastic: Sequence[torch.Tensor],
    row_len: Optional[Sequence[torch.Tensor]] = None,
    *,
    stdp: Dict[str, float],
    out: Optional[torch.Tensor] = None,
    own: Optional[Tuple[int, int]] = None,
    weights_out: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Launch the plastic post-exchange kernel: the ring as
    :func:`post_exchange_cuda` computes it from ``act_gather``, and every
    bucket's STDP update from ``act`` and ``pre_trace``.  ``act_gather``
    None with ``own=(lo, hi)``: the gather reads ``act`` with the ids
    ``lo..hi-1`` (the partition's own slice) as +0, in the kernel.
    ``row_len``: per bucket ``(R,)`` int32 real slots a row (real slots
    first, ``(col 0, weight +0, mask 0)`` after), or None (rows K long).
    Returns ``(new_ring, new_weights)``: the ring goes into ``out`` when
    given (``out`` may be ``ring``), the weights into ``weights_out`` (which
    may be ``weights``: in place) or into new copies of the panels; only
    plastic slots whose bits change are written."""
    _build.require_plastic_f32("post_exchange_plastic", weights)
    if (act_gather is None) == (own is None):
        raise ValueError("post_exchange_plastic gathers act_gather, or act with the own "
                         "slice own=(lo, hi) read as 0: give one of the two")
    acts = dict(act=act, pre_trace=pre_trace, post_trace=post_trace, post_spike=post_spike)
    if act_gather is not None:
        acts["act_gather"] = act_gather
    D, n_p, R = _check_post(
        "post_exchange_plastic", acts, ring, clear_mask, write_onehot, cols,
        dict(weights=weights, plastic=plastic), out,
    )
    n = act.shape[0]
    if (act_gather is not None and act_gather.shape != (n,)) or pre_trace.shape != (n,):
        raise ValueError(
            f"act_gather {None if act_gather is None else tuple(act_gather.shape)}, act "
            f"{tuple(act.shape)} and pre_trace {tuple(pre_trace.shape)} must share one length"
        )
    if post_trace.shape != (n_p,) or post_spike.shape != (n_p,):
        raise ValueError(
            f"post_trace {tuple(post_trace.shape)} and post_spike "
            f"{tuple(post_spike.shape)} for a ring of n_p={n_p} neurons"
        )
    lo, hi = (0, 0) if own is None else (int(own[0]), int(own[1]))
    if not 0 <= lo <= hi <= n:
        raise ValueError(f"own slice {own} outside the {n} ids")
    nd = len(cols)
    _build.check_row_len(row_len, nd, R, ring.device)
    out = torch.empty_like(ring) if out is None else out
    new_weights = _build.plastic_weights_out(weights, weights_out)
    if R == 0:
        return out, new_weights
    ptrs = ctypes.c_void_p * nd
    stream, device = _build.launch_args(ring)
    # the kernel takes act_gather == act as "gather act itself"
    gather = None if act_gather is None else act_gather.data_ptr()
    rc = _build.library().repro_post_exchange_plastic(
        gather, act.data_ptr(), pre_trace.data_ptr(), lo, hi - lo,
        ring.data_ptr(), out.data_ptr(), _ptr(clear_mask), write_onehot.data_ptr(),
        post_trace.data_ptr(), post_spike.data_ptr(), n_p, D, R, nd,
        ptrs(*[c.data_ptr() for c in cols]),
        ptrs(*[w.data_ptr() for w in new_weights]),
        ptrs(*[p.data_ptr() for p in plastic]),
        ptrs(*([None] * nd if row_len is None else [rl.data_ptr() for rl in row_len])),
        (ctypes.c_int * nd)(*[c.shape[1] for c in cols]),
        stdp["a_plus"], stdp["a_minus"], stdp["w_min"], stdp["w_max"],
        stream, device,
    )
    _build.check(rc, "post_exchange_plastic")
    PLASTIC_COUNTER.launches += 1
    return out, new_weights
