"""Public kernel entry points of the port (counterpart of
``repro/kernels/ops.py:53-426``).

Each op takes its backend from the device of its tensors
(``dispatch.backend_for``) and calls the recorded implementation: the CUDA
kernel wrapper for CUDA tensors, the plain torch version for CPU tensors.
The gathers' ``reduce`` argument picks the kernel's reduction
(``dispatch.launch_row_dot``); the plain versions sum every slot whatever
it says.
"""
from __future__ import annotations

from . import ref
from .dispatch import backend_for, implementation, lookup
from .event_step import event_post_exchange_cuda, event_post_exchange_plain
from .fused_step import (
    fused_step_cuda, fused_step_plastic_cuda, fused_step_plastic_plain,
)
from .keystream import keystream_cuda, keystream_plain
from .lif_step import lif_step_cuda
from .noise import noise_add_cuda, noise_add_plain, noise_cuda, noise_plain
from .segment_gather import segment_gather_ring_cuda, segment_gather_ring_plain
from .spike_gather import spike_gather_cuda
from .split_step import post_exchange_cuda, post_exchange_plastic_cuda, pre_exchange_cuda
from .step_front import step_front_cuda, step_front_plain
from .stdp_update import (
    stdp_update_cuda, stdp_update_plain, stdp_update_step_cuda, stdp_update_step_plain,
)

# -- builder_keystream (procedural construction word matrix) --------------

implementation("builder_keystream", "ref")(keystream_plain)
implementation("builder_keystream", "cuda")(keystream_cuda)


def builder_keystream(seed, stream, rows, j0, n_words):
    """Counter-based keystream words for the procedural network builder: a
    ``(len(rows), n_words)`` int32 tensor of uint32 bit patterns on
    ``rows``' device, bit-identical to ``builder/crng.py:word_matrix``."""
    return lookup("builder_keystream", backend_for(rows.device))(
        seed, stream, rows, j0, n_words
    )


# -- step_noise (the simulator's per-step noise) ---------------------------

implementation("step_noise", "ref")(noise_plain)
implementation("step_noise", "cuda")(noise_cuda)


def step_noise(seed, t, n, sigma, *, device):
    """The ``(n,)`` f32 noise of step ``t`` on ``device``: ``sigma`` times
    the normal of each id ``0..n-1``, a pure function of ``(seed, t, id)``
    with the reference's key and bits, the same on the card and on the
    CPU."""
    return lookup("step_noise", backend_for(device))(seed, t, n, sigma, device=device)


implementation("step_noise_add", "ref")(noise_add_plain)
implementation("step_noise_add", "cuda")(noise_add_cuda)


def step_noise_add(x, ids, seed, t, sigma, bias=None):
    """``out[r] = (x[r] + sigma * normal(seed, t, ids[r])) [+ bias[r]]``, a
    new f32 tensor on ``x``'s device: the noise of step ``t`` drawn at a
    partition's own permanent ``ids`` (int64) and added to ``x``, its
    delivered ring slot, then to ``bias`` (the strided ``LIF_BIAS`` column
    of ``vtx_state``, for the fused engines), each add one f32 rounding in
    the reference's order.  Bit for bit ``x + step_noise(seed, t, n,
    sigma)[ids]`` (then ``+ bias``), in one launch on the card.  ``t`` is
    an int or a 0-d int64 tensor on ``x``'s device (the simulator's carry),
    which stays there."""
    return lookup("step_noise_add", backend_for(x.device))(x, ids, seed, t, sigma, bias)


# -- step_front (noise, bias, LIF in place, history row: one launch) --------

implementation("step_front", "ref")(step_front_plain)
implementation("step_front", "cuda")(step_front_cuda)


def step_front(vtx, slot, ids, *, seed, t, sigma, draw, bias, hist_row, tr_plus=None,
               tr_minus=None, params, taus=None):
    """The step front of the split and event engines, everything before the
    exchange: ``i_tot = slot [+ sigma * normal(seed, t, ids)] [+
    vtx[:, LIF_BIAS]]``, each add one f32 rounding left to right (the
    reference's ``i_syn + noise + bias``), then the LIF advance on
    ``vtx[:, LIF_V]`` and ``vtx[:, LIF_REF]``, written back into ``vtx`` in
    place, the spikes written to ``hist_row`` (``hist[t % D]``, uint8) when
    it is given, and with ``tr_plus``/``tr_minus`` both trace decays.
    ``slot`` is read, not written.  ``t`` is an int or a 0-d int64 tensor
    on ``vtx``'s device; ``slot`` may be the ``(D, n)`` ring and
    ``hist_row`` the ``(D, n)`` history, whose rows ``t % D`` the op picks
    on the device.  Returns ``(spikes,)`` or ``(spikes, tr_plus',
    tr_minus')``, new tensors; one launch on the card, bit for bit
    ``step_noise_add`` (or the adds), ``fused_pre_exchange``, the column
    writes and the history write."""
    return lookup("step_front", backend_for(vtx.device))(
        vtx, slot, ids, seed=seed, t=t, sigma=sigma, draw=draw, bias=bias, hist_row=hist_row,
        tr_plus=tr_plus, tr_minus=tr_minus, params=params, taus=taus,
    )


# -- spike_gather ---------------------------------------------------------

@implementation("spike_gather", "ref")
def _spike_gather_ref(activity, cols, weights, row_len=None, *, reduce="row_dot"):
    # the slots past row_len are (col 0, weight 0): the whole row sums the
    # same; every slot is summed, whatever reduce says
    return ref.spike_gather_ref(activity, cols, weights)


implementation("spike_gather", "cuda")(spike_gather_cuda)


def spike_gather(activity, cols, weights, row_len=None, *, reduce="row_dot"):
    """``cur[r] = sum_k weights[r,k] * activity[cols[r,k]]`` (f32), for f32
    or bf16 ``weights`` (widened exactly, summed in f32) and any float
    ``activity``.

    ``row_len``, the ``(R,)`` int32 count of real slots per row (the ELL
    puts them first, ``(col 0, weight 0)`` after), lets the kernel skip the
    padding; None takes every row as ``K`` long.  ``reduce`` picks the
    kernel's reduction (``dispatch.launch_row_dot``): ``"row_dot"`` (the
    default) sums every slot, and the engines pass the choice recorded at
    upload (``PartitionDeviceData.reduce``, ``dispatch.panel_reduce``)."""
    return lookup("spike_gather", backend_for(activity.device))(
        activity, cols, weights, row_len, reduce=reduce
    )


# -- segment_gather_ring (the heavy-row split's step) -----------------------

implementation("segment_gather_ring", "ref")(segment_gather_ring_plain)
implementation("segment_gather_ring", "cuda")(segment_gather_ring_cuda)


def segment_gather_ring(act, ring, t, delays, plan, cols, weights, row_len=None, row_ptr=None,
                        *, reduce="row_dot"):
    """The gathers of a ``SimConfig(max_k=...)`` step added into the ring,
    in place: per bucket, a split bucket's virtual rows gathered and each
    real row's added in ascending order from ``+0.0`` (``row_ptr``, its
    ``(n_p + 1,)`` int32 offsets), or an unsplit bucket's first ``n_p`` rows
    (``row_ptr`` None), added into ``ring[(t + delay) % D]``.  ``t`` is an
    int or the 0-d int64 step on the ring's device, which stays there;
    ``plan`` is the upload's ``segment_plan``; ``row_len`` and ``reduce``
    as for :func:`spike_gather`, per bucket.  One launch on the card
    (``kernels/segment_gather.py``), which takes delays that differ modulo
    ``D``, as the step's do.  Returns ``ring``."""
    return lookup("segment_gather_ring", backend_for(act.device))(
        act, ring, t, tuple(delays), plan, tuple(cols), tuple(weights), _tuple(row_len),
        _tuple(row_ptr), reduce=reduce,
    )


# -- lif_step -------------------------------------------------------------

@implementation("lif_step", "ref")
def _lif_step_ref(v, refrac, i_syn, *, params):
    return ref.lif_step_ref(v, refrac, i_syn, **params)


implementation("lif_step", "cuda")(lif_step_cuda)


def lif_step(v, refrac, i_syn, *, params):
    """LIF advance: ``(v', refrac', spike)``."""
    return lookup("lif_step", backend_for(v.device))(v, refrac, i_syn, params=params)


# -- fused_step (LIF advance + spike emission + gather, one launch) -------

@implementation("fused_step", "ref")
def _fused_step_ref(v, refrac, i_tot, cols, weights, row_len=None, *, params,
                    reduce="row_dot"):
    return ref.fused_step_ref(v, refrac, i_tot, cols, weights, params=params)


implementation("fused_step", "cuda")(fused_step_cuda)


def fused_step(v, refrac, i_tot, cols, weights, row_len=None, *, params, reduce="row_dot"):
    """Fused LIF step: ``(v', refrac', spikes, per-bucket currents)``.

    ``cols``/``weights`` are per-delay-bucket (R, K_d) panels with common
    R, the weights all f32 or all bf16 (summed in f32); eligibility rules
    live in ``dispatch.select_step_engine``.
    ``row_len`` and ``reduce`` as for :func:`spike_gather`, per bucket."""
    return lookup("fused_step", backend_for(v.device))(
        v, refrac, i_tot, tuple(cols), tuple(weights), _tuple(row_len), params=params,
        reduce=reduce,
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


implementation("stdp_update_step", "ref")(stdp_update_step_plain)
implementation("stdp_update_step", "cuda")(stdp_update_step_cuda)


def stdp_update_step(
    weights, plastic, cols, pre_trace, pre_spike, post_trace, post_spike, *, plan, params,
):
    """Pair STDP over every delay bucket of a step, in place in
    ``weights`` (f32 panels, returned): each bucket as :func:`stdp_update`
    with ``valid = plastic[b]``, its post terms the ``(n_p,)``
    ``post_trace``/``post_spike`` padded with 0 to its rows, or taken
    through its row map (``plan.row_map``, a split bucket).  ``plan`` is
    the panels' ``stdp_update.StdpStepPlan`` (``stdp_step_plan``, made at
    upload)."""
    return lookup("stdp_update_step", backend_for(weights[0].device))(
        tuple(weights), tuple(plastic), tuple(cols), pre_trace, pre_spike, post_trace,
        post_spike, plan=plan, params=params,
    )


# -- fused_step_plastic (the fused step + trace decay + STDP write-back) ---

implementation("fused_step_plastic", "ref")(fused_step_plastic_plain)
implementation("fused_step_plastic", "cuda")(fused_step_plastic_cuda)


def fused_step_plastic(
    v, refrac, i_tot, tr_plus, tr_minus, cols, weights, plastic, row_len=None, *,
    params, taus, stdp, ring=None, t=None, delays=None, weights_out=None,
):
    """Plastic fused LIF step (identity exchange): LIF advance, spike
    emission, both trace decays, every bucket's gather from the pre-update
    weights and its masked STDP update, in one launch.  Returns ``(v',
    refrac', spikes, tr_plus', tr_minus', currents, new_weights)``.
    ``stdp`` carries a_plus/a_minus/w_min/w_max (other keys are ignored).
    ``row_len`` (per bucket ``(R,)`` int32 real slots a row, the ELL's real
    slots first and ``(col 0, weight +0, mask 0)`` after) lets the kernel
    read only the real slots.  The ring form, ``ring`` ``(D, n_p)`` with
    the step ``t`` (an int or the 0-d int64 step on the ring's device) and
    the buckets' ``delays`` (no two the same modulo ``D``), adds each
    bucket's currents into ``ring[(t + d) % D]`` in the same launch, one
    f32 add an element (the engine's step; the ring takes the currents'
    place in the result).  The new weights go into ``weights_out`` (it may
    be ``weights``: in place, the engine's carry) or new tensors."""
    return lookup("fused_step_plastic", backend_for(v.device))(
        v, refrac, i_tot, tr_plus, tr_minus,
        tuple(cols), tuple(weights), tuple(plastic), _tuple(row_len),
        params=params, taus=tuple(taus), stdp=stdp, ring=ring, t=t,
        delays=None if delays is None else tuple(delays), weights_out=weights_out,
    )


# -- event_post_exchange (spike-id compaction + flagged-block gather) -----

implementation("event_post_exchange", "ref")(event_post_exchange_plain)
implementation("event_post_exchange", "cuda")(event_post_exchange_cuda)


def event_post_exchange(act, ring, slot, write_slots, plan, cols, weights, row_len=None, *,
                        reduce="row_dot", clear=True):
    """Event-driven ring update, in place: clear ``ring[slot]``, then add
    each bucket's gather over the row blocks ``plan``'s touch bitmaps flag
    for the active ids of ``act`` to its ``ring[write_slot]``.  The slots
    are ints (``slot=None``: no clear), or ``slot`` is the step ``t``, a 0-d
    int64 tensor on the ring's device, and ``write_slots`` the buckets'
    delays: the slots ``t % D`` (cleared unless ``clear=False``) and ``(t +
    delay) % D``, chosen on the device (``kernels/event_step.py``).
    ``row_len`` (per bucket ``(R,)`` int32 real slots a row, or None) lets
    the kernel skip the padding; ``reduce`` as for :func:`spike_gather`, per
    bucket.  The weights are all f32 or all bf16 (widened exactly, summed in
    f32).  Returns the ``(nd, num_blocks)`` flags."""
    return lookup("event_post_exchange", backend_for(act.device))(
        act, ring, slot, tuple(write_slots), plan, tuple(cols), tuple(weights),
        _tuple(row_len), reduce=reduce, clear=clear,
    )


# -- the split (k>1) step ----------------------------------------------------
#
# Each post-exchange op returns the new ring; with ``out`` it writes it there
# (``out`` may be ``ring``: every ring element is read before it is written,
# by the same thread on the card).

def _into(out, ring):
    if out is not None:
        out.copy_(ring)
        return out
    return ring


def _tuple(row_len):
    return None if row_len is None else tuple(row_len)


@implementation("fused_pre_exchange", "ref")
def _fused_pre_exchange_ref(v, refrac, i_tot, tr_plus=None, tr_minus=None, *,
                            params, taus=None):
    return ref.fused_pre_exchange_ref(
        v, refrac, i_tot, tr_plus, tr_minus, params=params, taus=taus
    )


@implementation("fused_pre_exchange", "cuda")
def _fused_pre_exchange_cuda(v, refrac, i_tot, tr_plus=None, tr_minus=None, *,
                             params, taus=None):
    if tr_plus is None:  # the trace-free variant is lif_step, as in the reference
        return lif_step_cuda(v, refrac, i_tot, params=params)
    return pre_exchange_cuda(v, refrac, i_tot, tr_plus, tr_minus, params=params, taus=taus)


def fused_pre_exchange(v, refrac, i_tot, tr_plus=None, tr_minus=None, *, params,
                       taus=None):
    """Pre-exchange half of the split step: LIF advance and spike emission,
    plus both trace decays when traces are passed.  Returns ``(v', refrac',
    spikes[, tr_plus', tr_minus'])``."""
    return lookup("fused_pre_exchange", backend_for(v.device))(
        v, refrac, i_tot, tr_plus, tr_minus, params=params, taus=taus
    )


@implementation("fused_post_exchange", "ref")
def _fused_post_exchange_ref(act, ring, clear_mask, write_onehot, cols, weights,
                             row_len=None, *, reduce="row_dot", out=None):
    return _into(out, ref.fused_post_exchange_ref(
        act, ring, clear_mask, write_onehot, cols, weights))


implementation("fused_post_exchange", "cuda")(post_exchange_cuda)


def fused_post_exchange(act, ring, clear_mask, write_onehot, cols, weights, row_len=None, *,
                        reduce="row_dot", out=None):
    """Post-exchange half of the split step: ``ring * clear_mask``, then per
    bucket in order ``+ write_onehot[i] (x) gather_i(act)``.  ``row_len``
    and ``reduce`` as for :func:`spike_gather`, per bucket; the weights of
    all three passes are all f32 or all bf16 (widened exactly, summed in
    f32)."""
    return lookup("fused_post_exchange", backend_for(ring.device))(
        act, ring, clear_mask, write_onehot, tuple(cols), tuple(weights), _tuple(row_len),
        reduce=reduce, out=out,
    )


@implementation("fused_post_exchange_local", "ref")
def _fused_post_exchange_local_ref(act_local, ring, clear_mask, write_onehot, cols,
                                   weights, row_len=None, *, reduce="row_dot", out=None):
    return _into(out, ref.fused_post_exchange_local_ref(
        act_local, ring, clear_mask, write_onehot, cols, weights))


implementation("fused_post_exchange_local", "cuda")(post_exchange_cuda)


def fused_post_exchange_local(act_local, ring, clear_mask, write_onehot, cols, weights,
                              row_len=None, *, reduce="row_dot", out=None):
    """Local pass of the overlapped split step: the ring rotate and the
    gathers of the local sub-panels (local ids) from the partition's own
    ``(n_p,)`` activity."""
    return lookup("fused_post_exchange_local", backend_for(ring.device))(
        act_local, ring, clear_mask, write_onehot, tuple(cols), tuple(weights),
        _tuple(row_len), reduce=reduce, out=out,
    )


@implementation("fused_post_exchange_remote", "ref")
def _fused_post_exchange_remote_ref(act, ring, write_onehot, cols, weights, row_len=None, *,
                                    reduce="row_dot", out=None):
    return _into(out, ref.fused_post_exchange_remote_ref(
        act, ring, write_onehot, cols, weights))


@implementation("fused_post_exchange_remote", "cuda")
def _fused_post_exchange_remote_cuda(act, ring, write_onehot, cols, weights, row_len=None, *,
                                     reduce="row_dot", out=None):
    return post_exchange_cuda(act, ring, None, write_onehot, cols, weights, row_len,
                              reduce=reduce, out=out)


def fused_post_exchange_remote(act, ring, write_onehot, cols, weights, row_len=None, *,
                               reduce="row_dot", out=None):
    """Remote pass of the overlapped split step: the remote sub-panels'
    gathers added on top of the local pass's ring, with no clear."""
    return lookup("fused_post_exchange_remote", backend_for(ring.device))(
        act, ring, write_onehot, tuple(cols), tuple(weights), _tuple(row_len),
        reduce=reduce, out=out,
    )


@implementation("fused_post_exchange_plastic", "ref")
def _fused_post_exchange_plastic_ref(act, pre_trace, ring, clear_mask, write_onehot,
                                     post_trace, post_spike, cols, weights, plastic,
                                     row_len=None, *, stdp, out=None, weights_out=None):
    new_ring, new_w = ref.fused_post_exchange_plastic_ref(
        act, pre_trace, ring, clear_mask, write_onehot, post_trace, post_spike,
        cols, weights, plastic, stdp=stdp, weights_out=weights_out,
    )
    return _into(out, new_ring), new_w


@implementation("fused_post_exchange_plastic", "cuda")
def _fused_post_exchange_plastic_cuda(act, pre_trace, ring, clear_mask, write_onehot,
                                      post_trace, post_spike, cols, weights, plastic,
                                      row_len=None, *, stdp, out=None, weights_out=None):
    return post_exchange_plastic_cuda(
        act, act, pre_trace, ring, clear_mask, write_onehot, post_trace, post_spike,
        cols, weights, plastic, row_len, stdp=stdp, out=out, weights_out=weights_out,
    )


def fused_post_exchange_plastic(act, pre_trace, ring, clear_mask, write_onehot,
                                post_trace, post_spike, cols, weights, plastic, row_len=None, *,
                                stdp, out=None, weights_out=None):
    """Plastic post-exchange half: ring rotate, every bucket's gather from
    the pre-update weights and its masked STDP update.  Returns
    ``(new_ring, new_weights)``; the new weights go into ``weights_out``
    (it may be ``weights``: in place) or new tensors.  ``stdp`` carries
    a_plus/a_minus/w_min/w_max (other keys are ignored); ``row_len`` as for
    :func:`fused_step_plastic`."""
    return lookup("fused_post_exchange_plastic", backend_for(ring.device))(
        act, pre_trace, ring, clear_mask, write_onehot, post_trace, post_spike,
        tuple(cols), tuple(weights), tuple(plastic), _tuple(row_len), stdp=stdp, out=out,
        weights_out=weights_out,
    )


@implementation("fused_post_exchange_remote_plastic", "ref")
def _fused_post_exchange_remote_plastic_ref(act_remote, act, pre_trace, ring,
                                            write_onehot, post_trace, post_spike, cols,
                                            weights, plastic, row_len=None, *, stdp, out=None,
                                            own=None, weights_out=None):
    new_ring, new_w = ref.fused_post_exchange_remote_plastic_ref(
        act_remote, act, pre_trace, ring, write_onehot, post_trace, post_spike,
        cols, weights, plastic, stdp=stdp, own=own, weights_out=weights_out,
    )
    return _into(out, new_ring), new_w


@implementation("fused_post_exchange_remote_plastic", "cuda")
def _fused_post_exchange_remote_plastic_cuda(act_remote, act, pre_trace, ring,
                                             write_onehot, post_trace, post_spike, cols,
                                             weights, plastic, row_len=None, *, stdp, out=None,
                                             own=None, weights_out=None):
    return post_exchange_plastic_cuda(
        act_remote, act, pre_trace, ring, None, write_onehot, post_trace, post_spike,
        cols, weights, plastic, row_len, stdp=stdp, out=out, own=own, weights_out=weights_out,
    )


def fused_post_exchange_remote_plastic(act_remote, act, pre_trace, ring, write_onehot,
                                       post_trace, post_spike, cols, weights, plastic,
                                       row_len=None, *, stdp, out=None, own=None,
                                       weights_out=None):
    """Plastic remote pass of the overlapped split step: the gathers of
    ``act_remote`` (own slice zeroed) added to the ring with no clear, and
    the STDP update from the full ``act`` and ``pre_trace``.  With
    ``act_remote`` None and ``own=(lo, hi)`` the gather reads ``act`` with
    the own ids ``lo..hi-1`` as 0, in the kernel (no zeroed copy).  Returns
    ``(new_ring, new_weights)``; ``row_len`` and ``weights_out`` as for
    :func:`fused_post_exchange_plastic`."""
    return lookup("fused_post_exchange_remote_plastic", backend_for(ring.device))(
        act_remote, act, pre_trace, ring, write_onehot, post_trace, post_spike,
        tuple(cols), tuple(weights), tuple(plastic), _tuple(row_len), stdp=stdp, out=out,
        own=None if own is None else tuple(own), weights_out=weights_out,
    )
