"""Public kernel entry points of the port (counterpart of
``repro/kernels/ops.py:79-204, 362-393``).

Each op takes its backend from the device of its first tensor
(``dispatch.backend_for``) and calls the recorded implementation: the CUDA
kernel wrapper for CUDA tensors, the plain torch version for CPU tensors.
"""
from __future__ import annotations

from . import ref
from .dispatch import backend_for, implementation, lookup
from .event_step import event_post_exchange_cuda, event_post_exchange_plain
from .fused_step import (
    fused_step_cuda, fused_step_plastic_cuda, fused_step_plastic_plain,
)
from .lif_step import lif_step_cuda
from .spike_gather import spike_gather_cuda
from .stdp_update import stdp_update_cuda, stdp_update_plain

# -- spike_gather ---------------------------------------------------------

implementation("spike_gather", "ref")(ref.spike_gather_ref)
implementation("spike_gather", "cuda")(spike_gather_cuda)


def spike_gather(activity, cols, weights):
    """``cur[r] = sum_k weights[r,k] * activity[cols[r,k]]`` (f32)."""
    return lookup("spike_gather", backend_for(activity.device))(activity, cols, weights)


# -- lif_step -------------------------------------------------------------

@implementation("lif_step", "ref")
def _lif_step_ref(v, refrac, i_syn, *, params):
    return ref.lif_step_ref(v, refrac, i_syn, **params)


implementation("lif_step", "cuda")(lif_step_cuda)


def lif_step(v, refrac, i_syn, *, params):
    """LIF advance: ``(v', refrac', spike)``."""
    return lookup("lif_step", backend_for(v.device))(v, refrac, i_syn, params=params)


# -- fused_step (LIF advance + spike emission + gather, one launch) -------

implementation("fused_step", "ref")(ref.fused_step_ref)
implementation("fused_step", "cuda")(fused_step_cuda)


def fused_step(v, refrac, i_tot, cols, weights, *, params):
    """Fused LIF step: ``(v', refrac', spikes, per-bucket currents)``.

    ``cols``/``weights`` are per-delay-bucket (R, K_d) panels with common
    R; eligibility rules live in ``dispatch.select_step_engine``."""
    return lookup("fused_step", backend_for(v.device))(
        v, refrac, i_tot, tuple(cols), tuple(weights), params=params
    )


# -- stdp_update (pair STDP over one panel) --------------------------------

implementation("stdp_update", "ref")(stdp_update_plain)
implementation("stdp_update", "cuda")(stdp_update_cuda)


def stdp_update(
    weights, valid, cols, pre_trace, pre_spike, post_trace, post_spike, *,
    params, out=None,
):
    """Pair STDP: the ``(R, K)`` new weights of the ``valid`` slots, clipped
    to ``[w_min, w_max]``; other slots keep theirs.  ``params`` carries
    a_plus/a_minus/w_min/w_max (other keys are ignored).  With ``out`` the
    result goes there, and ``out`` may be ``weights`` (in place)."""
    return lookup("stdp_update", backend_for(weights.device))(
        weights, valid, cols, pre_trace, pre_spike, post_trace, post_spike,
        params=params, out=out,
    )


# -- fused_step_plastic (the fused step + trace decay + STDP write-back) ---

implementation("fused_step_plastic", "ref")(fused_step_plastic_plain)
implementation("fused_step_plastic", "cuda")(fused_step_plastic_cuda)


def fused_step_plastic(
    v, refrac, i_tot, tr_plus, tr_minus, cols, weights, plastic, *,
    params, taus, stdp,
):
    """Plastic fused LIF step (identity exchange): LIF advance, spike
    emission, both trace decays, every bucket's gather from the pre-update
    weights and its masked STDP update, in one launch.  Returns ``(v',
    refrac', spikes, tr_plus', tr_minus', currents, new_weights)``; the new
    weights are new tensors.  ``stdp`` carries a_plus/a_minus/w_min/w_max
    (other keys are ignored)."""
    return lookup("fused_step_plastic", backend_for(v.device))(
        v, refrac, i_tot, tr_plus, tr_minus,
        tuple(cols), tuple(weights), tuple(plastic),
        params=params, taus=tuple(taus), stdp=stdp,
    )


# -- event_post_exchange (spike-id compaction + flagged-block gather) -----

implementation("event_post_exchange", "ref")(event_post_exchange_plain)
implementation("event_post_exchange", "cuda")(event_post_exchange_cuda)


def event_post_exchange(act, ring, slot, write_slots, plan, cols, weights):
    """Event-driven ring update, in place: clear ``ring[slot]``, then add
    each bucket's gather over the row blocks ``plan``'s touch bitmaps flag
    for the active ids of ``act``.  Returns the ``(nd, num_blocks)`` flags."""
    return lookup("event_post_exchange", backend_for(act.device))(
        act, ring, slot, tuple(write_slots), plan, tuple(cols), tuple(weights)
    )
