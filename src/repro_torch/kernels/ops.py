"""Public kernel entry points of the port (counterpart of
``repro/kernels/ops.py:79-172, 362-393``).

Each op takes its backend from the device of its first tensor
(``dispatch.backend_for``) and calls the recorded implementation: the CUDA
kernel wrapper for CUDA tensors, the plain torch version for CPU tensors.
"""
from __future__ import annotations

from . import ref
from .dispatch import backend_for, implementation, lookup
from .event_step import event_post_exchange_cuda, event_post_exchange_plain
from .fused_step import fused_step_cuda
from .lif_step import lif_step_cuda
from .spike_gather import spike_gather_cuda

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
