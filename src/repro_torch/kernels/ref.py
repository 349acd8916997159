"""Plain torch versions of the port's kernels (the correctness contract).

Counterpart of ``repro/kernels/ref.py``: each function is the mathematical
definition its CUDA kernel must match, written with the reference's
operation order.  The kernel wrappers take these for CPU tensors, the CPU
tests hold them against the JAX oracles, and ``chip_smoke.py`` holds the
kernels against them on the card.  ``alif_step_ref`` and
``izhikevich_step_ref`` have no kernel, as in the reference, where they run
as jnp outside any Pallas kernel; ``trace_decay_ref`` runs as torch ops on
the unfused engine (the reference computes it as jnp there) and inside the
fused plastic kernel on the fused one.  ``step_noise_ref`` and
``step_noise_add_ref`` are the plain versions of ``csrc/noise.cu``, the
simulator's per-step noise, which the reference draws as jnp outside
Pallas; ``step_front_ref`` is the plain version of ``csrc/step_front.cu``,
the noise, the bias, the LIF advance and the history row of a step in one
pass.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..builder.crng import _C240, _ROT_A, _ROT_B

Tensor = torch.Tensor


@functools.lru_cache(maxsize=64)
def lif_constants(dt: float, tau_m: float, t_ref: float) -> Tuple[float, float]:
    """``(decay, ref_steps)``: ``exp(-dt/tau_m)`` rounded to f32 and
    ``round(t_ref/dt)``, computed once on the host (``ref.py:48,53`` of the
    reference) and handed to the plain version and the kernels alike."""
    decay = torch.exp(torch.tensor(-dt / tau_m, dtype=torch.float32)).item()
    return decay, float(round(t_ref / dt))


@functools.lru_cache(maxsize=64)
def trace_decay_constant(dt: float, tau: float) -> float:
    """``exp(-dt/tau)`` rounded to f32 once on the host, as the reference's
    ``jnp.exp(-dt / tau).astype(f32)`` (``ref.py:122`` of the reference),
    and handed to the plain version and the kernels alike."""
    return torch.exp(torch.tensor(-dt / tau, dtype=torch.float32)).item()


def spike_gather_ref(
    activity: Tensor,  # (n,) global activity (spikes as 0/1 floats)
    cols: Tensor,  # (R, K) int32 global source ids (0 on padding)
    weights: Tensor,  # (R, K) weights (0 on padding)
) -> Tensor:  # (R,)
    """currents[r] = sum_k weights[r,k] * activity[cols[r,k]], in f32.

    Padding slots carry weight 0, so no mask is needed (the layout
    invariant of ``core/ell.py``)."""
    vals = activity.index_select(0, cols.reshape(-1)).reshape(cols.shape)
    return torch.sum(weights.float() * vals.float(), dim=-1)


def segment_add_ref(cur: Tensor, row_ptr: Tensor, depth: Optional[int] = None) -> Tensor:
    """``out[r] = cur[row_ptr[r]] + ... + cur[row_ptr[r+1] - 1]``, added in
    ascending order to an f32 ``+0.0``: the reference's ``segment_sum`` over
    a split bucket's ``row_map`` (``repro/snn/simulator.py:648-653``; its
    padding rows add ``+0.0`` to row 0, which changes no sum that starts at
    ``+0.0``).  A loop over the split depth: step ``j`` adds each row's
    ``j``-th virtual row, or ``+0.0`` past its last.  ``depth``, the most
    virtual rows of one row, is read from ``row_ptr`` on the host when not
    given (the engines pass the one recorded at upload)."""
    starts = row_ptr[:-1]
    counts = row_ptr[1:] - starts
    if depth is None:
        depth = int(counts.max()) if counts.numel() else 0
    out = torch.zeros(counts.shape[0], dtype=torch.float32, device=cur.device)
    last = max(cur.shape[0] - 1, 0)
    for j in range(depth):
        take = cur.index_select(0, torch.clamp(starts + j, max=last))
        out = out + torch.where(counts > j, take, 0.0)
    return out


def spike_gather_segment_ref(
    activity: Tensor,  # (n,) global activity
    cols: Tensor,  # (R, K) int32, rows are virtual rows
    weights: Tensor,  # (R, K)
    row_ptr: Tensor,  # (n_out + 1,) int32 offsets of each real row's virtual rows
    row_len: Optional[Tensor] = None,
    *,
    depth: Optional[int] = None,
) -> Tensor:  # (n_out,)
    """The segmented gather of a heavy-row split bucket: the gather over
    every virtual row, then each real row's virtual rows added in ascending
    order (:func:`segment_add_ref`).  ``row_len`` is ignored, as in
    :func:`spike_gather_ref`: the slots past it are zero."""
    return segment_add_ref(spike_gather_ref(activity, cols, weights), row_ptr, depth)


def segment_gather_ring_ref(
    act: Tensor,  # (n,) activity
    ring: Tensor,  # (D, n_p) ring, updated in place
    t,  # the step: an int, or a 0-d integer tensor on the ring's device
    delays: Sequence[int],  # per bucket its delay
    cols: Sequence[Tensor],  # per bucket (R, K) int32; split buckets' rows are virtual rows
    weights: Sequence[Tensor],  # per bucket (R, K)
    row_ptr: Sequence[Optional[Tensor]],  # per bucket (n_p + 1,) int32 offsets, or None
    depth: Optional[Sequence[int]] = None,  # per bucket most virtual rows of a row
) -> Tensor:
    """The heavy-row split's step: per bucket in order, the segmented
    gather of a split bucket (:func:`spike_gather_segment_ref`), or an
    unsplit bucket's first ``n_p`` rows (:func:`spike_gather_ref`), added
    into ``ring[(t + d) % D]`` (:func:`add_currents_to_ring`).  Returns
    ``ring``."""
    currents = [
        spike_gather_ref(act, c, w) if rp is None else
        spike_gather_segment_ref(act, c, w, rp, depth=None if depth is None else depth[b])
        for b, (c, w, rp) in enumerate(zip(cols, weights, row_ptr))
    ]
    return add_currents_to_ring(ring, t, delays, currents)


def lif_step_ref(
    v: Tensor,  # (R,) membrane potential
    refrac: Tensor,  # (R,) remaining refractory steps (float, >= 0)
    i_syn: Tensor,  # (R,) synaptic current this step
    *,
    dt: float,
    tau_m: float,
    v_rest: float,
    v_reset: float,
    v_thresh: float,
    t_ref: float,
    r_m: float,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Leaky integrate-and-fire, exact exponential-Euler update; returns
    ``(v', refrac', spike)``.  During refractoriness the membrane is clamped
    to ``v_reset`` and input is discarded; the counter then decrements."""
    decay, ref_steps = lif_constants(dt, tau_m, t_ref)
    active = refrac <= 0
    v_int = v_rest + (v - v_rest) * decay + r_m * i_syn * (1.0 - decay)
    v_new = torch.where(active, v_int, torch.full_like(v, v_reset))
    spike = (v_new >= v_thresh) & active
    refrac_new = torch.where(
        spike, torch.full_like(refrac, ref_steps),
        torch.clamp_min(refrac - 1, 0.0),
    )
    v_out = torch.where(spike, torch.full_like(v, v_reset), v_new)
    return v_out, refrac_new, spike.to(v.dtype)


def alif_step_ref(
    v, refrac, adapt, i_syn, *, dt, tau_m, v_rest, v_reset, v_thresh,
    t_ref, r_m, tau_adapt, beta,
):
    """Adaptive LIF: threshold rises by beta per spike, decays with
    tau_adapt.  Returns (v', refrac', adapt', spike)."""
    decay, ref_steps = lif_constants(dt, tau_m, t_ref)
    a_decay = torch.exp(torch.tensor(-dt / tau_adapt, dtype=v.dtype)).item()
    active = refrac <= 0
    v_int = v_rest + (v - v_rest) * decay + r_m * i_syn * (1.0 - decay)
    v_new = torch.where(active, v_int, torch.full_like(v, v_reset))
    thresh = v_thresh + adapt
    spike = (v_new >= thresh) & active
    refrac_new = torch.where(
        spike, torch.full_like(refrac, ref_steps),
        torch.clamp_min(refrac - 1, 0.0),
    )
    adapt_new = adapt * a_decay + beta * spike.to(v.dtype)
    v_out = torch.where(spike, torch.full_like(v, v_reset), v_new)
    return v_out, refrac_new, adapt_new, spike.to(v.dtype)


def izhikevich_step_ref(v, u, i_syn, *, dt, a, b, c, d):
    """Izhikevich (2003) two-variable model, forward Euler.
    Returns (v', u', spike)."""
    spike = v >= 30.0
    v0 = torch.where(spike, torch.full_like(v, c), v)
    u0 = torch.where(spike, u + d, u)
    dv = 0.04 * v0 * v0 + 5.0 * v0 + 140.0 - u0 + i_syn
    du = a * (b * v0 - u0)
    return v0 + dt * dv, u0 + dt * du, spike.to(v.dtype)


def trace_decay_ref(trace: Tensor, spike: Tensor, *, dt: float, tau: float) -> Tensor:
    """``x' = x * exp(-dt/tau) + spike`` (per-neuron e-trace): one rounded
    multiply, then one rounded add."""
    return trace * trace_decay_constant(dt, tau) + spike


def stdp_update_ref(
    weights: Tensor,  # (R, K)
    valid: Tensor,  # (R, K) 0/1 float mask (the plastic slots)
    cols: Tensor,  # (R, K) int32 global pre ids
    pre_trace: Tensor,  # (n,) presynaptic traces
    pre_spike: Tensor,  # (n,) spike vector this step
    post_trace: Tensor,  # (R,) postsynaptic traces of the rows
    post_spike: Tensor,  # (R,) spikes of the rows this step
    *,
    a_plus: float,
    a_minus: float,
    w_min: float,
    w_max: float,
) -> Tensor:  # (R, K)
    """Trace-based pair STDP: potentiation ``a_plus * pre_trace[col]`` on a
    post spike, depression ``a_minus * post_trace[row]`` on a pre spike,
    applied together, then clipped to ``[w_min, w_max]``.  Slots with
    ``valid == 0`` (padding or non-plastic synapses) keep their weight.
    The reference's operation order:
    ``(a_plus * pre_t) * post_s - (a_minus * post_t) * pre_s``, then
    ``w + dw``, then the clip, then the mask.

    bf16 weights give bf16 weights, as ``stdp_update_pallas`` computes
    them: the four vectors rounded to bf16, the four scalars too (weak
    types in the reference, so 0-d bf16 tensors here: a Python float would
    keep torch's f32 opmath), and every op rounded to bf16."""
    if weights.dtype == torch.bfloat16:
        bf = torch.bfloat16
        a_plus, a_minus, w_min, w_max = (
            torch.tensor(x, dtype=bf, device=weights.device)
            for x in (a_plus, a_minus, w_min, w_max))
        pre_trace, pre_spike, post_trace, post_spike = (
            x.to(bf) for x in (pre_trace, pre_spike, post_trace, post_spike))
    return _pair_stdp(weights, valid, cols, pre_trace, pre_spike, post_trace, post_spike,
                      a_plus, a_minus, w_min, w_max)


def _pair_stdp(weights, valid, cols, pre_trace, pre_spike, post_trace, post_spike,
               a_plus, a_minus, w_min, w_max):
    """:func:`stdp_update_ref`'s arithmetic in torch's promotion: the fused
    plastic steps' STDP, which like the reference's oracles gives f32
    weights for bf16 ones with f32 traces (the reference's fused plastic
    Pallas kernels refuse bf16 weights)."""
    pre_t = pre_trace.index_select(0, cols.reshape(-1)).reshape(cols.shape)
    pre_s = pre_spike.index_select(0, cols.reshape(-1)).reshape(cols.shape)
    dw = (
        a_plus * pre_t * post_spike[:, None]
        - a_minus * post_trace[:, None] * pre_s
    )
    w = torch.clamp(weights + dw, w_min, w_max)
    return torch.where(valid > 0, w, weights)


def fused_step_ref(
    v: Tensor,  # (n_p,)
    refrac: Tensor,  # (n_p,)
    i_tot: Tensor,  # (n_p,) total input current
    cols: Sequence[Tensor],  # per delay bucket (R, K_d) int32, local ids
    weights: Sequence[Tensor],  # per delay bucket (R, K_d)
    *,
    params: Dict[str, float],
) -> Tuple[Tensor, Tensor, Tensor, List[Tensor]]:
    """The fused per-partition step composed from the two plain versions:
    LIF advance + spike emission + per-bucket gather-accumulate.  Returns
    ``(v', refrac', spikes, currents)``."""
    v2, r2, s = lif_step_ref(v, refrac, i_tot, **params)
    currents = [spike_gather_ref(s, c, w) for c, w in zip(cols, weights)]
    return v2, r2, s, currents


def _into_weights(new_weights: List[Tensor], weights_out) -> List[Tensor]:
    """The plastic plain versions' weights: ``new_weights`` as they are, or
    copied into ``weights_out`` (which may be the input panels: in place)."""
    if weights_out is None:
        return new_weights
    for o, w in zip(weights_out, new_weights):
        o.copy_(w)
    return list(weights_out)


def add_currents_to_ring(ring: Tensor, t, delays: Sequence[int], currents) -> Tensor:
    """Per bucket in order ``ring[(t + d) % D] += cur[:n_p]``, one f32 add an
    element: the reference's ``ring.at[(t + d) % D].add``
    (``repro/snn/simulator.py:654-655``).  The row index is made on the
    ring's device from ``t``; the add is ``index_put_`` with ``accumulate``
    (the CPU's ``index_add_`` starts every core's thread for one row).
    Returns ``ring``."""
    D, n_p = ring.shape
    for cur, d in zip(currents, delays):
        ring.index_put_((ring_row(t + d, D, ring.device),), cur[:n_p].unsqueeze(0),
                        accumulate=True)
    return ring


def fused_step_plastic_ref(
    v: Tensor,  # (n_p,)
    refrac: Tensor,  # (n_p,)
    i_tot: Tensor,  # (n_p,) total input current
    tr_plus: Tensor,  # (n_p,) presynaptic e-trace
    tr_minus: Tensor,  # (n_p,) postsynaptic e-trace
    cols: Sequence[Tensor],  # per delay bucket (R, K_d) int32, local ids
    weights: Sequence[Tensor],  # per delay bucket (R, K_d)
    plastic: Sequence[Tensor],  # per delay bucket (R, K_d) 0/1 STDP mask
    row_len: Optional[Sequence[Tensor]] = None,  # per bucket (R,) real slots; unread
    *,
    params: Dict[str, float],
    taus: Tuple[float, float],  # (tau_plus, tau_minus)
    stdp: Dict[str, float],  # a_plus / a_minus / w_min / w_max
    ring: Optional[Tensor] = None,  # (D, n_p): the ring form
    t=None,  # the step (an int or a 0-d integer tensor), with the ring
    delays: Optional[Sequence[int]] = None,  # per bucket its delay, with the ring
    weights_out: Optional[Sequence[Tensor]] = None,  # where the new weights go
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, object, List[Tensor]]:
    """The plastic fused step composed from the plain versions in the
    reference's step order: LIF advance, both trace decays, then per bucket
    the gather from the *pre-update* weights and the STDP update (identity
    exchange: the pre-spike is the spike vector, the pre-trace is
    ``tr_plus'``; rows ``r >= n_p`` take 0 for the post terms).  Returns
    ``(v', refrac', spikes, tr_plus', tr_minus', currents, new_weights)``;
    with ``ring`` (the ring form) each bucket's currents of rows ``< n_p``
    are added into ``ring[(t + d) % D]`` (:func:`add_currents_to_ring`)
    and the ring takes the currents' place.  The new weights go into
    ``weights_out`` when given (it may be ``weights``: in place).
    ``row_len`` changes nothing: the slots past it are ``(col 0, weight
    +0, mask 0)``, which add nothing and keep their weight."""
    v2, r2, s = lif_step_ref(v, refrac, i_tot, **params)
    dt = params["dt"]
    tp = trace_decay_ref(tr_plus, s, dt=dt, tau=taus[0])
    tm = trace_decay_ref(tr_minus, s, dt=dt, tau=taus[1])
    n_p = v.shape[0]
    currents, new_weights = [], []
    for c, w, pm in zip(cols, weights, plastic):
        currents.append(spike_gather_ref(s, c, w))
        pad_r = c.shape[0] - n_p
        post_t = torch.nn.functional.pad(tm, (0, pad_r)) if pad_r else tm
        post_s = torch.nn.functional.pad(s, (0, pad_r)) if pad_r else s
        new_weights.append(_pair_stdp(
            w, pm, c, tp, s, post_t, post_s,
            stdp["a_plus"], stdp["a_minus"], stdp["w_min"], stdp["w_max"],
        ))
    new_weights = _into_weights(new_weights, weights_out)
    if ring is not None:
        return v2, r2, s, tp, tm, add_currents_to_ring(ring, t, delays, currents), new_weights
    return v2, r2, s, tp, tm, currents, new_weights


# -- the split (k>1) step: pre-exchange and post-exchange halves -----------

def fused_pre_exchange_ref(
    v: Tensor,  # (n_p,)
    refrac: Tensor,  # (n_p,)
    i_tot: Tensor,  # (n_p,) total input current (syn + noise + bias)
    tr_plus: Tensor = None,  # (n_p,) presynaptic e-trace (optional)
    tr_minus: Tensor = None,  # (n_p,) postsynaptic e-trace (optional)
    *,
    params: Dict[str, float],
    taus: Tuple[float, float] = None,  # (tau_plus, tau_minus) with traces
):
    """Everything before the spike exchange: LIF advance and spike
    emission, plus both trace decays when traces are passed.  Returns
    ``(v', refrac', spikes)`` or ``(v', refrac', spikes, tr_plus',
    tr_minus')``."""
    v2, r2, s = lif_step_ref(v, refrac, i_tot, **params)
    if tr_plus is None:
        return v2, r2, s
    dt = params["dt"]
    return (
        v2, r2, s,
        trace_decay_ref(tr_plus, s, dt=dt, tau=taus[0]),
        trace_decay_ref(tr_minus, s, dt=dt, tau=taus[1]),
    )


def _ring_accumulate(ring, clear_mask, write_onehot, currents):
    """The reference's ring formulation (ground rule (e)): the rotate as a
    mask multiply, then per bucket in order ``+ onehot[i] (x) cur_i``.
    ``clear_mask=None`` is the remote passes' clear of ones (``x * 1`` is
    ``x`` bit for bit, so the multiply is left out)."""
    new_ring = ring if clear_mask is None else ring * clear_mask[:, None]
    for i, cur in enumerate(currents):
        new_ring = new_ring + write_onehot[i][:, None] * cur[None, :]
    return new_ring


def fused_post_exchange_ref(
    act: Tensor,  # (n,) exchanged global activity
    ring: Tensor,  # (D, n_p) future-current ring buffer (uncleared)
    clear_mask: Tensor,  # (D,) 0 at the just-delivered slot, 1 else
    write_onehot: Tensor,  # (nd, D) one-hot of (t + d) % D per bucket
    cols: Sequence[Tensor],  # per delay bucket (R, K_d) int32, global ids
    weights: Sequence[Tensor],  # per delay bucket (R, K_d)
) -> Tensor:
    """Everything after the spike exchange: the ring rotate (clear the
    delivered slot) and every delay bucket's gather-accumulate.  Returns
    the new ring."""
    n_p = ring.shape[1]
    currents = [spike_gather_ref(act, c, w)[:n_p] for c, w in zip(cols, weights)]
    return _ring_accumulate(ring, clear_mask, write_onehot, currents)


def fused_post_exchange_local_ref(
    act_local: Tensor,  # (n_p,) own-partition activity (before the exchange)
    ring: Tensor,  # (D, n_p) ring (uncleared)
    clear_mask: Tensor,  # (D,)
    write_onehot: Tensor,  # (nd, D)
    cols: Sequence[Tensor],  # per delay bucket (R, K_l) int32, LOCAL ids
    weights: Sequence[Tensor],
) -> Tensor:
    """The local pass of the overlapped split step: the ring rotate and the
    gathers of the local sub-panels from the partition's own activity."""
    return fused_post_exchange_ref(act_local, ring, clear_mask, write_onehot, cols, weights)


def fused_post_exchange_remote_ref(
    act: Tensor,  # (n,) exchanged global activity
    ring: Tensor,  # (D, n_p) ring already rotated by the local pass
    write_onehot: Tensor,  # (nd, D)
    cols: Sequence[Tensor],  # per delay bucket (R, K_r) int32, remote ids
    weights: Sequence[Tensor],
) -> Tensor:
    """The remote pass of the overlapped split step: the remote sub-panels'
    gathers added on top of the local pass's ring, with no clear."""
    n_p = ring.shape[1]
    currents = [spike_gather_ref(act, c, w)[:n_p] for c, w in zip(cols, weights)]
    return _ring_accumulate(ring, None, write_onehot, currents)


def _post_exchange_plastic(
    act_gather, act, pre_trace, ring, clear_mask, write_onehot, post_trace,
    post_spike, cols, weights, plastic, stdp, weights_out=None,
):
    n_p = ring.shape[1]
    currents, new_weights = [], []
    for c, w, pm in zip(cols, weights, plastic):
        currents.append(spike_gather_ref(act_gather, c, w)[:n_p])
        pad_r = c.shape[0] - n_p
        post_t = torch.nn.functional.pad(post_trace, (0, pad_r)) if pad_r else post_trace
        post_s = torch.nn.functional.pad(post_spike, (0, pad_r)) if pad_r else post_spike
        new_weights.append(_pair_stdp(
            w, pm, c, pre_trace, act, post_t, post_s,
            stdp["a_plus"], stdp["a_minus"], stdp["w_min"], stdp["w_max"],
        ))
    return (_ring_accumulate(ring, clear_mask, write_onehot, currents),
            _into_weights(new_weights, weights_out))


def fused_post_exchange_plastic_ref(
    act: Tensor,  # (n,) exchanged global activity
    pre_trace: Tensor,  # (n,) exchanged global presynaptic traces
    ring: Tensor,  # (D, n_p) ring (uncleared)
    clear_mask: Tensor,  # (D,)
    write_onehot: Tensor,  # (nd, D)
    post_trace: Tensor,  # (n_p,) local postsynaptic traces (updated)
    post_spike: Tensor,  # (n_p,) local spikes this step
    cols: Sequence[Tensor],  # per delay bucket (R, K_d) int32, global ids
    weights: Sequence[Tensor],
    plastic: Sequence[Tensor],  # per delay bucket (R, K_d) 0/1 STDP mask
    row_len: Optional[Sequence[Tensor]] = None,  # per bucket (R,) real slots; unread
    *,
    stdp: Dict[str, float],  # a_plus / a_minus / w_min / w_max
    weights_out: Optional[Sequence[Tensor]] = None,  # where the new weights go
) -> Tuple[Tensor, List[Tensor]]:
    """The plastic post-exchange half: ring rotate, every bucket's gather
    from the pre-update weights and its masked STDP update, in one pass
    over the panels.  Returns ``(new_ring, new_weights)``; the new weights
    go into ``weights_out`` when given (it may be ``weights``: in place).
    ``row_len`` changes nothing, as in :func:`fused_step_plastic_ref`."""
    return _post_exchange_plastic(
        act, act, pre_trace, ring, clear_mask, write_onehot, post_trace,
        post_spike, cols, weights, plastic, stdp, weights_out,
    )


def mask_own(act: Tensor, own: Tuple[int, int]) -> Tensor:
    """``act`` with the ids ``own[0]..own[1]-1`` (a partition's own slice)
    zeroed, as a new tensor: the remote pass's gather activity."""
    out = act.clone()
    out[own[0]:own[1]] = 0.0
    return out


def fused_post_exchange_remote_plastic_ref(
    act_remote: Optional[Tensor],  # (n,) exchanged activity, own slice zeroed
    act: Tensor,  # (n,) full exchanged activity (for STDP)
    pre_trace: Tensor,  # (n,) exchanged global presynaptic traces
    ring: Tensor,  # (D, n_p) ring already rotated by the local pass
    write_onehot: Tensor,  # (nd, D)
    post_trace: Tensor,  # (n_p,)
    post_spike: Tensor,  # (n_p,)
    cols: Sequence[Tensor],  # per delay bucket (R, K_d), the FULL panels
    weights: Sequence[Tensor],
    plastic: Sequence[Tensor],
    row_len: Optional[Sequence[Tensor]] = None,  # per bucket (R,) real slots; unread
    *,
    stdp: Dict[str, float],
    own: Optional[Tuple[int, int]] = None,  # with act_remote None: the own slice
    weights_out: Optional[Sequence[Tensor]] = None,
) -> Tuple[Tensor, List[Tensor]]:
    """The plastic remote pass of the overlapped split step: the gathers of
    ``act_remote`` (or, when it is None, of ``act`` with the ids of ``own``
    zeroed, :func:`mask_own`) added to the ring with no clear, and the STDP
    update from the full ``act`` and ``pre_trace`` (elementwise per slot,
    so the weights equal the serialized pass's).  Returns ``(new_ring,
    new_weights)``, the weights into ``weights_out`` when given."""
    if act_remote is None:
        act_remote = mask_own(act, own)
    return _post_exchange_plastic(
        act_remote, act, pre_trace, ring, None, write_onehot, post_trace,
        post_spike, cols, weights, plastic, stdp, weights_out,
    )


# -- Threefry-2x32-20 and the per-step noise --------------------------------

_M32 = 0xFFFFFFFF


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32_ref(k0: int, k1: int, c0: Tensor, c1: Tensor) -> Tuple[Tensor, Tensor]:
    """Threefry-2x32-20 of the counters ``(c0, c1)`` under the key ``(k0,
    k1)``, in int64 holding uint32 values: every add and left shift is
    masked to 32 bits, so the right shifts are logical.  Equals
    ``builder/crng.py:threefry2x32`` and ``csrc/threefry.cuh`` bit for bit."""
    ks = (k0, k1, k0 ^ k1 ^ _C240)
    x0 = (c0 + ks[0]) & _M32
    x1 = (c1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT_A if i % 2 == 0 else _ROT_B:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & _M32
    return x0, x1


def step_key_ref(seed: int, t):
    """The reference's key of step ``t``, ``fold_in(PRNGKey(seed), t)``:
    ``PRNGKey(seed)`` is ``(0, seed mod 2^32)`` (jax without x64), and
    ``fold_in`` applies the cipher to the counter pair ``(0, t mod 2^32)``.
    An int ``t`` gives two ints; a 0-d integer tensor (a simulator's carry)
    gives two 0-d int64 tensors on its device, and is never read back to
    the host."""
    if torch.is_tensor(t):
        t = t.to(torch.int64)
        return threefry2x32_ref(0, int(seed) & _M32, torch.zeros_like(t), t & _M32)
    one = torch.ones((), dtype=torch.int64)
    x0, x1 = threefry2x32_ref(0, int(seed) & _M32, 0 * one, (int(t) & _M32) * one)
    return int(x0), int(x1)


def noise_bits_ref(seed: int, t: int, n: int, device=None) -> Tensor:
    """``jax.random.bits(fold_in(PRNGKey(seed), t), (n,), uint32)`` as int64:
    ``x0 ^ x1`` of the cipher under the step key at the counter pair ``(i >>
    32, i & 0xffffffff)`` of each id ``i`` (jax's partitionable threefry)."""
    return noise_bits_at_ref(seed, t, torch.arange(n, dtype=torch.int64, device=device))


def noise_bits_at_ref(seed: int, t, ids: Tensor) -> Tensor:
    """The raw bits of step ``t`` (an int, or a 0-d integer tensor on the
    ids' device) at the given int64 ids (read as uint64):
    ``noise_bits_ref(seed, t, n)[ids]`` for ids below ``n``, without drawing
    the others."""
    k0, k1 = step_key_ref(seed, t)
    ids = ids.to(torch.int64)
    x0, x1 = threefry2x32_ref(k0, k1, (ids >> 32) & _M32, ids & _M32)
    return x0 ^ x1


def _f32(x) -> Tensor:
    return torch.tensor(x, dtype=torch.float32)


# nextafter(-1, 0): the lower end of jax.random.normal's uniform
_U_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def noise_uniform_ref(bits: Tensor) -> Tensor:
    """``jax.random.uniform`` over ``[nextafter(-1, 0), 1)`` from raw bits:
    the top 23 bits as the mantissa of a float in [1, 2), minus 1, times 2,
    plus the lower end, then the max with it."""
    lo = _f32(_U_LO).to(bits.device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    u = (f - 1.0) * 2.0 + lo
    return torch.maximum(u, lo)


# Cephes' logf polynomial, and ln2 split as 0.693359375 + LOG_C1
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
          1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
          3.3333331174E-1)
_LOG_C1 = -2.12194440e-4
_LOG_C2 = 0.693359375
_SQRT_HALF = 0.707106781186547524
# Giles' single-precision erfinv (XLA's coefficients): w < 5, w >= 5
_ERFINV_A = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
             0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_B = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
             0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def log_ref(y: Tensor) -> Tensor:
    """Cephes' logf for normal ``y > 0``: ``y = m * 2^e`` from the float's
    bits, ``m`` in ``[sqrt(1/2), sqrt(2))``, a fixed polynomial in ``m - 1``,
    then ``e * ln2`` in two parts.  f32, one correctly rounded op at a time;
    ``csrc/noise.cu:cephes_log`` runs the same operations."""
    yb = y.view(torch.int32)
    e = (yb >> 23) - 126
    m = ((yb & 0x807FFFFF) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    small = m < _SQRT_HALF
    e = torch.where(small, e - 1, e).to(torch.float32)
    x = torch.where(small, (m + m) - 1.0, m - 1.0)
    z = x * x
    p = torch.full_like(x, _LOG_P[0])
    for c in _LOG_P[1:]:
        p = p * x + c
    r = (x * z) * p
    r = r + e * _LOG_C1
    r = r + z * -0.5
    return (x + r) + e * _LOG_C2


def log1p_ref(v: Tensor) -> Tensor:
    """``log1p(v)`` for ``v`` in ``(-1, 0]``: ``v`` where ``1 + v`` rounds
    to 1, else ``log(1 + v) * (v / ((1 + v) - 1))`` (the difference is
    exact), which keeps what the rounding of ``1 + v`` loses."""
    y = v + 1.0
    d = y - 1.0
    zero = d == 0
    scaled = log_ref(y) * (v / torch.where(zero, torch.ones_like(d), d))
    return torch.where(zero, v, scaled)


def sqrt_rn_ref(x: Tensor) -> Tensor:
    """The correctly rounded f32 square root of ``x >= 0``, as IEEE defines
    it (``__fsqrt_rn`` on the card).  ``torch.sqrt`` need not be: on some
    CPUs its vector code is within 0.5001 ulp, and then differs from the
    card.  So the root, taken in f64 and rounded (within one ulp), is moved
    to its neighbour where ``x`` lies beyond the midpoint between them:
    the midpoints have 25 bits, so their squares, and the comparison, are
    exact in f64 (and never tie with a 24-bit ``x``)."""
    s = torch.sqrt(x.double()).float()
    up = torch.nextafter(s, torch.full_like(s, float("inf")))
    down = torch.nextafter(s, torch.zeros_like(s))
    x64, s64 = x.double(), s.double()
    hi = (s64 + up.double()) * 0.5
    lo = (s64 + down.double()) * 0.5
    return torch.where(x64 > hi * hi, up, torch.where(x64 < lo * lo, down, s))


def erfinv_ref(x: Tensor) -> Tensor:
    """Giles' single-precision erfinv as XLA expands it, for ``|x| < 1``:
    ``w = -log1p(-x*x)``; below 5 a polynomial in ``w - 2.5``, else in
    ``sqrt(w) - 3`` (coefficients selected per element, Horner with a
    separate multiply and add); times ``x``.  The square root is
    :func:`sqrt_rn_ref`, correctly rounded on every device."""
    t = x * x
    w = -log1p_ref(-t)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt_rn_ref(w) - 3.0)
    p = torch.where(lt, _f32(_ERFINV_A[0]), _f32(_ERFINV_B[0]))
    for a, b in zip(_ERFINV_A[1:], _ERFINV_B[1:]):
        p = torch.where(lt, _f32(a), _f32(b)) + p * w
    return p * x


def noise_normal_ref(bits: Tensor) -> Tensor:
    """``jax.random.normal``'s transform of raw bits: ``sqrt(2) *
    erfinv(uniform)``, with the port's own log1p (the normals differ from
    XLA's by up to 4.8e-7, ``tests/test_torch_noise.py``)."""
    return _SQRT2 * erfinv_ref(noise_uniform_ref(bits))


def step_noise_ref(seed: int, t: int, n: int, sigma: float, *, device=None) -> Tensor:
    """The ``(n,)`` f32 noise of step ``t``: ``sigma * normal`` of each id's
    raw bits, a pure function of ``(seed, t, id)`` -- the reference's
    ``sigma * jax.random.normal(fold_in(PRNGKey(seed), t), (n,))`` up to the
    normal transform's rounding.  ``sigma`` is rounded to f32 first, as the
    kernel and the reference take it."""
    return noise_normal_ref(noise_bits_ref(seed, t, n, device)) * _f32(sigma).to(device)


def step_noise_add_ref(x: Tensor, ids: Tensor, seed: int, t, sigma: float,
                       bias: Optional[Tensor] = None) -> Tensor:
    """``(x + sigma * normal(seed, t, ids)) [+ bias]``, each add one f32
    rounding, left to right: the reference's ``i_syn + noise + bias``
    (``repro/snn/simulator.py:409-438``) with the noise drawn at a
    partition's own ids, equal bit for bit to ``x + step_noise_ref(seed, t,
    n, sigma)[ids]`` (then ``+ bias``).  ``t`` is an int or the simulator's
    0-d int64 step tensor, which stays on its device."""
    z = noise_normal_ref(noise_bits_at_ref(seed, t, ids)) * _f32(sigma).to(x.device)
    out = x + z
    return out if bias is None else out + bias


# vtx_state's LIF columns, as snn/neurons.py lays them out (LIF_V, LIF_REF,
# LIF_BIAS; that module imports this one, so the indices are repeated here)
LIF_COLUMNS = (0, 1, 2)


def ring_row(t, rows: int, device) -> Tensor:
    """The row ``t % rows`` of a ``(rows, n)`` ring or history that step
    ``t`` selects, as a ``(1,)`` int64 index on ``device`` for
    ``index_select``/``index_copy_``; ``t`` is an int or a 0-d integer tensor
    there, which is never read back to the host."""
    if torch.is_tensor(t):
        return torch.remainder(t.to(torch.int64), rows).view(1)
    return torch.tensor([int(t) % rows], dtype=torch.int64, device=device)


def step_row(x: Tensor, t) -> Tensor:
    """``x`` itself when it is one ``(n,)`` row, else the row ``t %
    len(x)`` of the ``(D, n)`` ring ``x``, as a new tensor."""
    if x.dim() == 1:
        return x
    return x.index_select(0, ring_row(t, x.shape[0], x.device))[0]


def step_front_ref(
    vtx: Tensor,  # (n, ld) LIF vtx_state; v and refrac written in place
    slot: Tensor,  # (n,) the delivered ring slot, or the (D, n) ring
    ids: Optional[Tensor],  # (n,) int64 permanent ids (read with draw)
    *,
    seed: int,
    t,  # the step: an int or a 0-d integer tensor on vtx's device
    sigma: float,
    draw: bool,
    bias: bool,
    hist_row: Optional[Tensor],  # (n,) uint8 or the (D, n) hist, written in place, or None
    tr_plus: Optional[Tensor] = None,
    tr_minus: Optional[Tensor] = None,
    params: Dict[str, float],
    taus: Optional[Tuple[float, float]] = None,
) -> Tuple[Tensor, ...]:
    """The step front: ``i_tot = slot [+ sigma * normal(seed, t, ids)] [+
    bias]`` (each add one f32 rounding, left to right, as
    :func:`step_noise_add_ref`), then :func:`fused_pre_exchange_ref` on
    ``vtx``'s ``v`` and ``refrac`` columns, which it writes back into
    ``vtx``; the spikes go to ``hist_row`` as uint8.  A 2-D ``slot`` is the
    ``(D, n)`` ring, whose row ``t % D`` is delivered, and a 2-D
    ``hist_row`` the ``(D, n)`` history, whose row ``t % D`` is written.
    Returns ``(spikes,)`` or, with traces, ``(spikes, tr_plus', tr_minus')``
    (new tensors)."""
    c_v, c_ref, c_bias = LIF_COLUMNS
    slot = step_row(slot, t)
    b = vtx[:, c_bias] if bias else None
    if draw:
        i_tot = step_noise_add_ref(slot, ids, seed, t, sigma, b)
    else:
        i_tot = slot if b is None else slot + b
    v2, r2, *rest = fused_pre_exchange_ref(vtx[:, c_v], vtx[:, c_ref], i_tot, tr_plus,
                                           tr_minus, params=params, taus=taus)
    vtx[:, c_v] = v2
    vtx[:, c_ref] = r2
    if hist_row is not None and hist_row.dim() == 2:
        hist_row.index_copy_(0, ring_row(t, hist_row.shape[0], hist_row.device),
                             rest[0].to(torch.uint8)[None])
    elif hist_row is not None:
        hist_row.copy_(rest[0].to(torch.uint8))
    return tuple(rest)
