"""Clock-driven SNN simulator over one dCSR partition, in torch.

Counterpart of ``repro/snn/simulator.py``: the shared per-partition step
(:func:`make_core_step`) of every engine, and the k = 1 :class:`Simulator`
(``snn/dist_sim.py`` drives the same step for k > 1).  One step, in the
reference's documented order:

  1. deliver: ``i_syn = ring[t % D]``; clear that slot.
  2. neuron update with ``i_syn + noise(t, permanent id) + bias`` -> spikes;
     on plastic nets both e-traces decay, ``x' = x * exp(-dt/tau) + s``.
  3. exchange: the spike vector (and on plastic nets the pre-trace) becomes
     the global activity (identity at k = 1).
  4. propagate: per delay bucket b in order,
     ``ring[(t + d_b) % D] += spike_gather(act, cols_b, w_b)[:n_p]``;
     on plastic nets the bucket's STDP update follows its gather, from the
     weights the gather read.
  5. history: ``hist[t % D] = spikes``; ``t += 1``.

The k = 1 engines: ``fused`` does 2 and the gathers of 4 in one cooperative
kernel launch, and ``fused_plastic`` also the trace decays and the STDP
updates; ``fused_event`` launches the step front (``ops.step_front``: the
noise, the bias, LIF in place in ``vtx_state`` and the history row of 5, in
one launch) and then one cooperative kernel that clears the slot of 1 and
gathers only the row blocks the step's spikes touch.  The split engines
(k > 1) run the step front (2, with the trace decays on plastic nets), the
exchange, then one post-exchange launch that rotates the ring with the
reference's mask multiply and adds every bucket through a one-hot
(``fused_split``, ``fused_split_plastic`` with STDP, ``fused_split_event``
over the flagged row blocks).  ``unfused`` launches ``lif_step`` and then
one ``spike_gather`` per bucket, and on plastic nets decays the traces as
torch ops and launches one ``stdp_update`` per bucket.  All go through the
same device routines, so their rasters, traces and weights are
bit-identical on the card (the split engines' ring may hold ``-0.0`` where
the others hold ``+0.0``), and through the same plain versions on the CPU.
Plastic nets never take the event gather
(``dispatch.event_gather_blocker``).

``SimConfig(overlap=...)`` splits the split engines' post-exchange pass
into a local pass over the own partition's synapses and a remote pass
(``local``), or defers the remote pass of step t to the top of step t + 1
(``double_buffer``, a ``_pending`` entry of the carry that the run flushes
at its end); the remote pass adds on top of the local pass's ring, so the
ring may differ from ``off`` in its last bits, while raster, traces and
weights are the reference's observable set.

``lax.scan`` becomes a Python loop over steps with no host sync inside a
run: spike counts, raster rows and ``v_mean`` go into tensors preallocated
on the run's device and are copied to the host once, by the caller.  The
carry's tensors are updated in place after ``run`` has copied them (the
weights too, on plastic nets), so the state a caller passes in is never
changed.

``SimConfig(gather="auto")``, the default, starts on the dense gather and
lets ``Session``'s chunk loop switch to the event-driven engine while the
running spike rate stays under ``EVENT_ACTIVITY_THRESHOLD``, as the
reference does.  The engines give identical rasters, so the switch never
changes a trajectory.

Noise is a pure function of (seed, t, permanent neuron id): the normals
come from counters alone (Threefry under the reference's key
``fold_in(PRNGKey(seed), t)``, the reference's bits and uniforms, and the
normal transform in correctly rounded f32 operations), so each partition
draws exactly its own rows' ids, and adds them to its delivered ring slot
(and the bias) in the same launch (``ops.step_front`` or
``ops.step_noise_add``); a row gets the
value its permanent id has in the step's ``(n_global,)`` vector
(``ops.step_noise``).  The noise is the same on the card and on the CPU; it
differs from ``jax.random.normal``'s by up to 4.8e-7 (the normal
transform's log1p), so cross-package raster tests inject the reference's
noise through the ``_noise_fn`` seam of :class:`Simulator` and
``DistSimulator``, which adds a full vector through ``index_select``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.dcsr import DCSRNetwork, DCSRPartition
from ..core.ell import DelayELL, build_delay_ell
from ..kernels import ops, ref
from ..kernels.dispatch import (
    StepEngineChoice, backend_for, panel_reduce, resolve_device, select_step_engine,
)
from ..kernels.event_step import EventPlan, event_id_cap
from .neurons import LIF_BIAS, LIF_PARAM_KEYS, LIF_REF, LIF_V, make_neuron_step
from .reshard import RUNTIME_KEYS, concat_runtime


def _not_ported(what: str, queue_item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, modules "
        f"still to port: {queue_item})"
    )


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """User-facing simulation knobs (the reference's fields and checks).

    Values the reference accepts but this slice does not run raise
    ``NotImplementedError`` at construction, naming the ROADMAP queue item
    that ports them.  There is no ``backend`` field: the run's device
    decides between the CUDA kernels and the plain versions."""

    fused: Optional[bool] = None  # None=auto, True=require fused step, False=off
    align_k: int = 128
    align_rows: int = 8
    max_k: Optional[int] = None  # heavy-row split cap
    record_raster: bool = False
    record_v: bool = False
    exchange: str = "auto"
    index_cap_frac: float = 0.25
    gather: str = "auto"
    event_cap_frac: float = 0.05
    overlap: str = "auto"
    seed: int = 42

    def __post_init__(self):
        if self.exchange not in ("auto", "dense", "index"):
            raise ValueError(
                f"SimConfig(exchange={self.exchange!r}): expected 'auto', "
                "'dense' or 'index'"
            )
        if not 0.0 < self.index_cap_frac <= 1.0:
            raise ValueError(
                f"SimConfig(index_cap_frac={self.index_cap_frac}): the "
                "compressed-exchange capacity is a fraction of the "
                "partition size and must lie in (0, 1]"
            )
        if self.gather not in ("auto", "dense", "event"):
            raise ValueError(
                f"SimConfig(gather={self.gather!r}): expected 'auto', "
                "'dense' or 'event'"
            )
        if not 0.0 < self.event_cap_frac <= 1.0:
            raise ValueError(
                f"SimConfig(event_cap_frac={self.event_cap_frac}): the "
                "compressed spike-id capacity is a fraction of the "
                "activity-vector width and must lie in (0, 1]"
            )
        if self.overlap not in ("auto", "off", "local", "double_buffer"):
            raise ValueError(
                f"SimConfig(overlap={self.overlap!r}): expected 'auto', "
                "'off', 'local' or 'double_buffer'"
            )
        if self.align_k < 1 or self.align_rows < 1:
            raise ValueError(
                f"SimConfig(align_k={self.align_k}, "
                f"align_rows={self.align_rows}): ELL alignments must be >= 1"
            )
        if self.max_k is not None:
            raise _not_ported(
                "SimConfig(max_k=...) heavy-row split (segment_sum on CUDA "
                "needs atomics, which break determinism)",
                "k=1 simulator, heavy-row split",
            )


@dataclasses.dataclass
class PartitionDeviceData:
    """Device-resident constants and initial state for one partition.

    Unlike the reference, no ``valid`` panels are built, and the
    ``plastic`` panels only for plastic nets: they are as large as the
    weights and no other engine reads them.  The overlap sub-panels
    (``split_overlap_panels``) exist only for the non-plastic split engines
    with an overlap mode: local panels hold LOCAL ids (``< n_p``), remote
    panels global ids of other partitions.

    Every panel set carries its row lengths and its ``reduce``, per bucket
    the reduction its gathers take (``dispatch.panel_reduce``), chosen once
    from the data at upload: ``"active"`` (only real slots and active
    sources' weights) where the weights are all finite and never change,
    ``"row_dot"`` (every slot, the reference's NaN) where one is not finite
    or the partition is plastic.  ``Session.describe()`` shows it."""

    n_p: int
    vtx_model: torch.Tensor
    vtx_state0: torch.Tensor
    delays: Tuple[int, ...]
    cols: List[torch.Tensor]  # per bucket (R, K) int32 (global ids)
    weights0: List[torch.Tensor]  # per bucket (R, K) f32
    # per bucket (R,) int32 real slots a row: the ELL puts a row's synapses
    # at 0..row_len-1 and (col 0, weight 0) after them, so the gathers
    # (spike_gather, event_post_exchange, fused_step, post_exchange) read
    # no padding
    row_len: List[torch.Tensor]
    reduce: Tuple[str, ...]  # per bucket "active" or "row_dot"
    identity_rows: Tuple[bool, ...]
    # per bucket (R, K) f32 0/1 mask of the syn_stdp slots; None when the
    # partition has no plastic synapse
    plastic: Optional[List[torch.Tensor]] = None
    cols_local: Optional[List[torch.Tensor]] = None  # per bucket (R, K_l)
    weights_local: Optional[List[torch.Tensor]] = None
    row_len_local: Optional[List[torch.Tensor]] = None  # per bucket (R,) int32
    reduce_local: Optional[Tuple[str, ...]] = None
    cols_remote: Optional[List[torch.Tensor]] = None  # per bucket (R, K_r)
    weights_remote: Optional[List[torch.Tensor]] = None
    row_len_remote: Optional[List[torch.Tensor]] = None
    reduce_remote: Optional[Tuple[str, ...]] = None

    @property
    def any_plastic(self) -> bool:
        return self.plastic is not None


def checked_cols(panels: Sequence[np.ndarray], bound: int, what: str, device) -> List[torch.Tensor]:
    """Upload col panels after checking every id lies in ``[0, bound)``:
    the kernels read ``act[cols]`` without a bounds check."""
    out = []
    for i, c in enumerate(panels):
        if c.size and not 0 <= int(c.min()) <= int(c.max()) < bound:
            raise ValueError(f"{what} panel {i} has col ids outside [0, {bound})")
        out.append(torch.from_numpy(np.ascontiguousarray(c)).to(device))
    return out


def plastic_masks(part: DCSRPartition, ell: DelayELL, stdp_id: int) -> Optional[List[np.ndarray]]:
    """Per bucket (R, K) f32 0/1 masks of the syn_stdp slots
    (``repro/snn/simulator.py:174-185``), or None when the partition has no
    plastic synapse."""
    if not np.any(part.edge_model == stdp_id):
        return None
    masks = []
    for b in ell.buckets:
        is_stdp = np.zeros(b.cols.shape, dtype=np.float32)
        sel = b.edge_index >= 0
        is_stdp[sel] = part.edge_model[b.edge_index[sel]] == stdp_id
        masks.append(is_stdp)
    return masks


def row_lengths(valid: Sequence[np.ndarray], device) -> List[torch.Tensor]:
    """Per bucket the ``(R,)`` int32 count of valid slots of each row of a
    ``(R, K)`` validity panel."""
    return [torch.from_numpy(np.asarray(v).sum(axis=1, dtype=np.int32)).to(device)
            for v in valid]


def partition_device_data(
    part: DCSRPartition, ell: DelayELL, device: torch.device, stdp_id: int
) -> PartitionDeviceData:
    plastic = plastic_masks(part, ell, stdp_id)
    weights0 = [torch.from_numpy(b.weights).to(device) for b in ell.buckets]
    return PartitionDeviceData(
        n_p=part.n,
        vtx_model=torch.from_numpy(part.vtx_model).to(device),
        vtx_state0=torch.from_numpy(part.vtx_state).to(device),
        delays=tuple(b.delay for b in ell.buckets),
        cols=checked_cols([b.cols for b in ell.buckets], ell.n_global, "delay-bucket", device),
        weights0=weights0,
        row_len=row_lengths([b.valid for b in ell.buckets], device),
        reduce=panel_reduce(weights0, plastic is not None),
        identity_rows=tuple(b.identity_rows for b in ell.buckets),
        plastic=None if plastic is None else [torch.from_numpy(m).to(device) for m in plastic],
    )


def state_reduce(dev: PartitionDeviceData, weights: Sequence[torch.Tensor]) -> Tuple[str, ...]:
    """Per bucket the reduction of the gathers over a state's ``weights``:
    the upload's ``dev.reduce`` where they are the uploaded panels (every
    state ``init_state`` makes; a non-plastic net never changes them) or the
    net is plastic (``row_dot`` whatever they hold); otherwise chosen now
    from these weights, one ``isfinite().all()`` a panel, since a state made
    elsewhere (a carried reference state, say) may hold weights that are
    not finite.  A run computes it once, as the carry's ``_reduce``."""
    if dev.any_plastic or all(w is w0 for w, w0 in zip(weights, dev.weights0)):
        return dev.reduce
    return panel_reduce(weights)


def load_runtime_arrays(carry: Dict, arrays: Dict[str, np.ndarray], where: str) -> Dict:
    """``carry`` with each restored runtime array (``RUNTIME_KEYS``) copied
    into a tensor on the carry's device, with its dtype (float32 ring and
    traces, uint8 ``hist``); an array whose shape differs from the carry's
    (another ring depth or partition size) raises ``ValueError``."""
    out = dict(carry)
    for key, arr in arrays.items():
        like = carry[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(
                f"{where}: the snapshot's {key} has shape {tuple(arr.shape)}, this "
                f"engine's carry {tuple(like.shape)} (ring depth and rows must match)"
            )
        out[key] = torch.tensor(np.asarray(arr), dtype=like.dtype, device=like.device)
    return out


def _models_present(net: DCSRNetwork) -> Tuple[str, ...]:
    names = []
    for i, spec in enumerate(net.registry.vertex_models()):
        if any(np.any(p.vtx_model == i) for p in net.parts):
            names.append(spec.name)
    return tuple(names)


def make_noise(noise_fn: Callable[[int], object], device) -> Callable[[int], torch.Tensor]:
    """The noise seam: ``noise(t)`` is ``noise_fn(t)``, the ``(n_global,)``
    f32 noise of step ``t`` (already scaled by sigma), a numpy-convertible
    vector or a torch tensor, on ``device``.  Cross-package tests inject the
    reference's noise through it.  The port's own noise needs no seam: each
    step draws it at the partition's ids (``ops.step_noise_add``,
    :func:`make_core_step`), equal to ``ops.step_noise``'s full vector
    there."""

    def noise(t: int) -> torch.Tensor:
        v = noise_fn(t)
        if isinstance(v, torch.Tensor):
            return v.to(device=device, dtype=torch.float32)
        return torch.tensor(np.asarray(v), dtype=torch.float32, device=device)

    return noise


# the engines whose step begins with the step front (ops.step_front): every
# fused engine whose LIF advance runs in a launch of its own
FRONT_ENGINES = ("fused_event", "fused_split", "fused_split_event", "fused_split_plastic")


def slot_tables(d_ring: int, delays: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split engines' slot arithmetic as device tables, indexed by
    ``t % D`` on the host (a view, no transfer): ``clear[t % D]`` is the
    ``(D,)`` mask with 0 at the delivered slot, ``onehot[t % D]`` the
    ``(nd, D)`` one-hot of each bucket's write slot ``(t + d) % D``
    (``repro/snn/simulator.py:420-431``)."""
    rows = torch.arange(d_ring)
    clear = (rows[:, None] != rows[None, :]).to(torch.float32)
    write = (rows[:, None] + torch.tensor(list(delays), dtype=torch.int64)[None, :]) % d_ring
    onehot = (write[:, :, None] == rows[None, None, :]).to(torch.float32)
    return clear.to(device), onehot.to(device)


def make_core_step(
    *,
    registry,
    models_present: Sequence[str],
    dt: float,
    noise_sigma: float,
    seed: int,
    d_ring: int,
    dev: PartitionDeviceData,
    noise_ids: torch.Tensor,
    engine_choice: StepEngineChoice,
    stdp_params: Optional[Dict[str, float]] = None,
    event_plan: Optional[EventPlan] = None,
    noise_fn: Optional[Callable[[int], object]] = None,
    overlap_ctx: Optional[Dict[str, Callable]] = None,
    front: bool = True,
) -> Callable:
    """The per-partition step: ``step(carry)`` advances ``carry`` in place
    by one step and returns the step's spike vector.

    ``engine_choice`` comes from ``dispatch.select_step_engine``; the event
    engines need the partition's ``event_plan``.  ``stdp_params`` are the
    registry's ``syn_stdp`` params, needed on plastic partitions (those
    whose ``dev.plastic`` is set).  ``noise_ids`` are the permanent neuron
    ids of the local rows.  ``noise_fn(t)``, when given, supplies the
    ``(n_global,)`` noise of step ``t`` in place of the port's own noise.

    The noise: with the port's own (no ``noise_fn``, ``noise_sigma > 0``)
    each step draws the partition's ids and adds them to the delivered ring
    slot in one launch, which on the fused engines also adds the bias: the
    step front (``ops.step_front``) on ``FRONT_ENGINES``, which advances the
    neurons and writes the history row in the same launch, and
    ``ops.step_noise_add`` on ``fused`` and ``fused_plastic``.  With
    ``noise_fn`` a step adds the seam's ``(n_global,)`` vector through
    ``index_select`` first.  Both add ``i_syn + noise + bias`` left to
    right, as the reference does, so the port's own noise gives the same
    bits either way.  ``front=False`` runs ``FRONT_ENGINES`` through the
    chain the front replaced (``ops.step_noise_add``, the two column
    copies, ``lif_step`` or ``fused_pre_exchange``, the two column writes
    and ``post``'s history write), bit for bit the same step: the tests and
    ``chip_smoke.py`` hold the front against it.

    ``step`` runs the k = 1 step, whose exchange is the identity.  A driver
    of k partitions (``snn/dist_sim.py``) calls the halves itself:
    ``step.pre(carry, noise_g)`` up to the exchange (returns ``(spikes,
    tr_plus)``; ``noise_g`` is the seam's ``(n_global,)`` noise of the step,
    drawn once for all partitions, or None, when the step draws its own or
    the net is noise-free), then its exchange over all partitions, then
    ``step.post(carry, spikes, act, pre_trace)`` with the exchanged
    activity and pre-trace.  The carry holds ``_reduce``, the reduction of
    the gathers over its weights (:func:`state_reduce`), which the driver
    sets once a run.

    ``overlap_ctx`` (needed when ``engine_choice.overlap`` is not
    ``"off"``) holds the partition-geometry closures of the overlap
    engines: ``local(spikes)`` the own slice of the activity as the
    exchange would deliver it, ``embed(v)`` the own slice placed into a
    zeroed global vector, ``mask_remote(act)`` the activity with the own
    slice zeroed.  With ``double_buffer`` the carry holds a ``_pending``
    entry (step t's deferred remote pass), applied at the top of step t+1
    and by ``step.pending_flush(carry)``, which a run calls at its end."""
    D = d_ring
    n_p = dev.n_p
    device = dev.vtx_state0.device
    choice = engine_choice
    if choice.event and event_plan is None:
        raise ValueError(f"the {choice.engine} engine needs the partition's EventPlan")
    plastic = dev.any_plastic
    if plastic and stdp_params is None:
        raise ValueError("a plastic partition needs the syn_stdp params")
    if choice.plastic != plastic and choice.engine != "unfused":
        raise ValueError(f"the {choice.engine} engine does not fit a "
                         f"{'plastic' if plastic else 'non-plastic'} partition")
    overlap_on = choice.overlap in ("local", "double_buffer")
    if overlap_on and overlap_ctx is None:
        raise ValueError(
            f"engine {choice.engine!r} resolved overlap={choice.overlap!r} but no "
            "overlap_ctx was given: the driver must supply the local/embed/"
            "mask_remote closures"
        )
    if overlap_on and not plastic and dev.cols_local is None:
        raise ValueError("the non-plastic overlap engines need the local and remote sub-panels")
    taus = (stdp_params["tau_plus"], stdp_params["tau_minus"]) if plastic else None
    if choice.fused:
        neuron_step = None
        lif_p = dict(registry.spec("lif").params)
        lif_params = {"dt": dt, **{k: lif_p[k] for k in LIF_PARAM_KEYS}}
    else:
        neuron_step = make_neuron_step(registry, models_present, dt)
    own_noise = noise_fn is None and noise_sigma > 0
    use_front = front and choice.engine in FRONT_ENGINES
    seam_noise = None if noise_fn is None else make_noise(noise_fn, device)
    clear_tab, onehot_tab = slot_tables(D, dev.delays, device) if choice.split else (None, None)

    def apply_pending(carry: Dict) -> None:
        """Step t-1's deferred remote pass, before step t reads or clears a
        slot (a delay-1 contribution from t-1 lands in the slot delivered at
        t), so the per-slot add sequence is that of ``local``.  An empty
        record applies nothing: the reference's ``where`` guard, taken on
        the host."""
        pend = carry.pop("_pending", None)
        if pend is None:
            return
        ring = carry["ring"]
        if choice.plastic:
            _, new_w = ops.fused_post_exchange_remote_plastic(
                overlap_ctx["mask_remote"](pend["act"]), pend["act"], pend["pre_trace"],
                ring, pend["onehot"], pend["post_trace"], pend["post_spike"],
                dev.cols, carry["weights"], dev.plastic, stdp=stdp_params, out=ring,
            )
            carry["weights"] = tuple(new_w)
        elif choice.event:
            ops.event_post_exchange(
                overlap_ctx["mask_remote"](pend["act"]), ring, None, pend["write_slots"],
                event_plan, dev.cols, carry["weights"], dev.row_len, reduce=carry["_reduce"],
            )
        else:
            ops.fused_post_exchange_remote(
                pend["act"], ring, pend["onehot"], dev.cols_remote, dev.weights_remote,
                dev.row_len_remote, reduce=dev.reduce_remote, out=ring,
            )

    def chain(carry: Dict, noise_g: Optional[torch.Tensor]) -> torch.Tensor:
        """``pre``'s work without the step front (every engine but
        ``FRONT_ENGINES``, and those with ``front=False``): the step's
        input current as a new tensor, then the neuron step; returns the
        spikes.  The k = 1 single-launch engines also propagate here."""
        t = carry["t"]
        slot = t % D
        ring = carry["ring"]
        vtx = carry["vtx_state"]
        # i_syn + noise (+ bias on the fused engines, whose neuron step is
        # inside their kernel)
        bias = vtx[:, LIF_BIAS] if choice.fused else None
        if own_noise:
            i_in = ops.step_noise_add(ring[slot], noise_ids, seed, t, noise_sigma, bias)
        else:
            i_in = ring[slot].clone() if noise_g is None else (
                ring[slot] + noise_g.to(device).index_select(0, noise_ids))
            if bias is not None:
                i_in += bias
        if not (choice.split or choice.event):
            # the split and event kernels rotate the ring themselves
            ring[slot] = 0.0
        if not choice.fused:
            new_vtx, spikes = neuron_step(dev.vtx_model, vtx, i_in)
            vtx.copy_(new_vtx)
            if plastic:
                # the trace decays as torch ops, as the reference runs them
                # as jnp outside any kernel
                carry["tr_plus"] = ref.trace_decay_ref(carry["tr_plus"], spikes, dt=dt, tau=taus[0])
                carry["tr_minus"] = ref.trace_decay_ref(carry["tr_minus"], spikes, dt=dt, tau=taus[1])
            return spikes
        v, refrac = vtx[:, LIF_V].contiguous(), vtx[:, LIF_REF].contiguous()
        if choice.engine == "fused":
            # one cooperative launch: LIF advance + spike emission + every
            # bucket's gather from the fresh spike vector
            v2, r2, spikes, currents = ops.fused_step(
                v, refrac, i_in, dev.cols, carry["weights"], dev.row_len,
                params=lif_params, reduce=carry["_reduce"],
            )
            for cur, d in zip(currents, dev.delays):
                ring[(t + d) % D] += cur[:n_p]
        elif choice.engine == "fused_plastic":
            # one cooperative launch: LIF advance + both trace decays, then
            # per bucket the gather from the pre-update weights and the
            # masked STDP update (identity exchange: the pre-spike is the
            # spike vector, the pre-trace tr_plus')
            (v2, r2, spikes, carry["tr_plus"], carry["tr_minus"], currents,
             new_weights) = ops.fused_step_plastic(
                v, refrac, i_in, carry["tr_plus"], carry["tr_minus"], dev.cols,
                carry["weights"], dev.plastic, params=lif_params, taus=taus,
                stdp=stdp_params,
            )
            carry["weights"] = tuple(new_weights)
            for cur, d in zip(currents, dev.delays):
                ring[(t + d) % D] += cur[:n_p]
        elif choice.plastic:  # fused_split_plastic: LIF + both trace decays
            v2, r2, spikes, carry["tr_plus"], carry["tr_minus"] = ops.fused_pre_exchange(
                v, refrac, i_in, carry["tr_plus"], carry["tr_minus"],
                params=lif_params, taus=taus,
            )
        else:  # fused_event, fused_split, fused_split_event: LIF alone (lif_step)
            v2, r2, spikes = ops.fused_pre_exchange(v, refrac, i_in, params=lif_params)
        vtx[:, LIF_V] = v2
        vtx[:, LIF_REF] = r2
        return spikes

    def pre(carry: Dict, noise_g: Optional[torch.Tensor]):
        """Deliver, add the noise, advance the neurons (and the traces);
        returns ``(spikes, tr_plus)`` for the exchange.  The k = 1
        engines also propagate here."""
        if choice.overlap == "double_buffer":
            apply_pending(carry)
        t = carry["t"]
        slot = t % D
        ring = carry["ring"]
        if use_front:
            # one launch: the noise and the bias added to the delivered slot
            # (read in place: the split and event kernels rotate the ring
            # later in the step), LIF in place in vtx_state, the history row
            # (and both trace decays, as new tensors: post's pending record
            # keeps tr_minus)
            x = ring[slot] if noise_g is None else (
                ring[slot] + noise_g.to(device).index_select(0, noise_ids))
            spikes, *traces = ops.step_front(
                carry["vtx_state"], x, noise_ids, seed=seed, t=t, sigma=noise_sigma,
                draw=own_noise, bias=True, hist_row=carry["hist"][slot],
                tr_plus=carry["tr_plus"] if plastic else None,
                tr_minus=carry["tr_minus"] if plastic else None, params=lif_params, taus=taus,
            )
            if plastic:
                carry["tr_plus"], carry["tr_minus"] = traces
        else:
            spikes = chain(carry, noise_g)
        if choice.engine == "fused_event":
            # one launch that compresses the spikes to ids, flags the touched
            # row blocks and adds only their gathers to the ring (the
            # delivered slot cleared first)
            ops.event_post_exchange(
                spikes, ring, slot, [(t + d) % D for d in dev.delays],
                event_plan, dev.cols, carry["weights"], dev.row_len, reduce=carry["_reduce"],
            )
        return spikes, carry["tr_plus"]

    def post(carry: Dict, spikes: torch.Tensor, act: torch.Tensor, pre_trace: torch.Tensor) -> None:
        """Propagate the exchanged activity into the ring (and learn), then
        record the history and advance ``t``."""
        t = carry["t"]
        slot = t % D
        ring = carry["ring"]
        weights = carry["weights"]
        if choice.split:
            clear, onehot = clear_tab[slot], onehot_tab[slot]
            write_slots = [(t + d) % D for d in dev.delays]
        if choice.split and overlap_on:
            if choice.plastic:
                # plastic panels are never split (the weights are state):
                # the local pass gathers the full panels from the own slice
                # embedded in a zeroed global vector
                ops.fused_post_exchange_local(
                    overlap_ctx["embed"](overlap_ctx["local"](spikes)), ring, clear,
                    onehot, dev.cols, weights, dev.row_len, reduce=carry["_reduce"], out=ring,
                )
            else:
                ops.fused_post_exchange_local(
                    overlap_ctx["local"](spikes), ring, clear, onehot, dev.cols_local,
                    dev.weights_local, dev.row_len_local, reduce=dev.reduce_local, out=ring,
                )
            pend = dict(act=act, onehot=onehot, write_slots=write_slots)
            if choice.plastic:
                pend.update(pre_trace=pre_trace, post_trace=carry["tr_minus"], post_spike=spikes)
            carry["_pending"] = pend
            if choice.overlap == "local":
                apply_pending(carry)
        elif choice.engine == "fused_split":
            ops.fused_post_exchange(act, ring, clear, onehot, dev.cols, weights, dev.row_len,
                                    reduce=carry["_reduce"], out=ring)
        elif choice.engine == "fused_split_event":
            ops.event_post_exchange(act, ring, slot, write_slots, event_plan, dev.cols, weights,
                                    dev.row_len, reduce=carry["_reduce"])
        elif choice.engine == "fused_split_plastic":
            _, new_w = ops.fused_post_exchange_plastic(
                act, pre_trace, ring, clear, onehot, carry["tr_minus"], spikes, dev.cols,
                weights, dev.plastic, stdp=stdp_params, out=ring,
            )
            carry["weights"] = tuple(new_w)
        elif not choice.fused:
            if plastic:
                pad_r = dev.cols[0].shape[0] - n_p  # rows >= n_p: post terms 0
                post_t = torch.nn.functional.pad(carry["tr_minus"], (0, pad_r))
                post_s = torch.nn.functional.pad(spikes, (0, pad_r))
            for i, (c, w, d) in enumerate(zip(dev.cols, weights, dev.delays)):
                ring[(t + d) % D] += ops.spike_gather(act, c, w, dev.row_len[i],
                                                      reduce=carry["_reduce"][i:i + 1])[:n_p]
                if plastic:
                    # in place: run() cloned the weights, and the gather
                    # above read them first
                    ops.stdp_update(w, dev.plastic[i], c, pre_trace, act, post_t,
                                    post_s, params=stdp_params, out=w)
        if not use_front:  # the front wrote it
            carry["hist"][slot] = spikes.to(torch.uint8)
        carry["t"] = t + 1

    def step(carry: Dict) -> torch.Tensor:
        spikes, tr_plus = pre(carry, None if seam_noise is None else seam_noise(carry["t"]))
        post(carry, spikes, spikes, tr_plus)  # the identity exchange
        return spikes

    def pending_flush(carry: Dict) -> None:
        """Apply and drop a trailing ``_pending`` entry (the run's end)."""
        apply_pending(carry)

    step.engine_choice = choice
    step.pre = pre
    step.post = post
    step.pending_flush = pending_flush
    return step


class Simulator:
    """Single-partition (k = 1) step engine behind :class:`Session`; its
    exchange is the identity, so an explicit ``SimConfig(overlap=...)``
    resolves to ``"off"`` (and raises with ``fused=True``), as in the
    reference.

    ``device`` is where it runs: the card unless the caller names another
    (``device="cpu"`` runs the plain torch versions).  ``_noise_fn`` is the
    internal noise seam (see :func:`make_core_step`).

    ``gather`` is the panel traversal the next :meth:`run` takes,
    ``"dense"`` or ``"event"``; ``SimConfig(gather="auto")`` starts dense,
    and ``Session`` moves it with :meth:`set_gather`.  The step function of
    each mode is built on first use and kept, so a switch back and forth
    costs nothing after the first."""

    def __init__(
        self,
        net: DCSRNetwork,
        cfg: Optional[SimConfig] = None,
        *,
        device=None,
        _noise_fn: Optional[Callable[[int], object]] = None,
    ):
        if net.k != 1:
            raise ValueError("Simulator takes k=1 nets; Session merges k>1 nets")
        cfg = SimConfig() if cfg is None else cfg
        self.net = net
        self.cfg = cfg
        self.device = resolve_device(device)
        self.backend = backend_for(self.device)
        self.dt = float(net.meta.get("dt", 0.1))
        self.noise_sigma = float(net.meta.get("noise_sigma", 0.0))
        part = net.parts[0]
        self.ell = build_delay_ell(
            part, net.n, align_k=cfg.align_k, align_rows=cfg.align_rows,
        )
        self.d_ring = max(self.ell.max_delay, 1)
        self.dev = partition_device_data(
            part, self.ell, self.device, net.registry.edge_id("syn_stdp")
        )
        # the registry's STDP params (repro/snn/simulator.py:734-738)
        self.stdp_params = (
            dict(net.registry.spec("syn_stdp").params) if self.dev.any_plastic else None
        )
        self._noise_ids = torch.from_numpy(part.global_ids).to(self.device)
        self._noise_fn = _noise_fn
        self._models = _models_present(net)
        self._steps: Dict[str, Callable] = {}
        self._event_plan: Optional[EventPlan] = None
        # False on plastic nets, whose every step must visit every panel
        # (dispatch.event_gather_blocker): gather="auto" then stays dense
        try:
            self.event_capable = self._choice("event").event
        except ValueError:  # fused=True on a partition that cannot fuse
            self.event_capable = False
        if self.event_capable and cfg.gather == "auto":
            self.set_gather("event")  # built here, not inside a later run
        self.set_gather("dense" if cfg.gather == "auto" else cfg.gather)

    def _choice(self, gather: str) -> StepEngineChoice:
        return select_step_engine(
            backend=self.backend,
            models_present=self._models,
            identity_rows=all(self.dev.identity_rows),
            n_delay_buckets=len(self.dev.delays),
            any_plastic=self.dev.any_plastic,
            identity_exchange=True,
            n_global=self.net.n,
            fused=self.cfg.fused,
            gather=gather,
            overlap=self.cfg.overlap,
        )

    @property
    def event_plan(self) -> EventPlan:
        """The event engine's touch bitmaps on the device, built on first
        use from the host ELL."""
        if self._event_plan is None:
            self._event_plan = EventPlan.build(
                [b.cols for b in self.ell.buckets],
                [b.valid for b in self.ell.buckets],
                self.net.n,
                event_id_cap(self.net.n, self.cfg.event_cap_frac),
                self.device,
            )
        return self._event_plan

    def _make_step(self, gather: str, *, front: bool = True) -> Callable:
        """The step function of ``gather`` on this simulator's panels;
        ``front=False`` takes the chain the step front replaced
        (:func:`make_core_step`)."""
        choice = self._choice(gather)
        return make_core_step(
            registry=self.net.registry,
            models_present=self._models,
            dt=self.dt,
            noise_sigma=self.noise_sigma,
            seed=self.cfg.seed,
            d_ring=self.d_ring,
            dev=self.dev,
            noise_ids=self._noise_ids,
            engine_choice=choice,
            stdp_params=self.stdp_params,
            event_plan=self.event_plan if choice.event else None,
            noise_fn=self._noise_fn,
            front=front,
        )

    def set_gather(self, gather: str) -> None:
        """Run the next steps with the ``"dense"`` or ``"event"`` gather."""
        if gather not in self._steps:
            self._steps[gather] = self._make_step(gather)
        self.gather = gather
        self._step = self._steps[gather]

    @property
    def engine_choice(self) -> StepEngineChoice:
        """The step engine the next :meth:`run` takes."""
        return self._step.engine_choice

    def init_state(self, t0: int = 0) -> Dict:
        n_p = self.dev.n_p
        zeros = dict(dtype=torch.float32, device=self.device)
        return dict(
            t=int(t0),
            vtx_state=self.dev.vtx_state0.clone(),
            ring=torch.zeros((self.d_ring, n_p), **zeros),
            hist=torch.zeros(
                (self.d_ring, n_p), dtype=torch.uint8, device=self.device
            ),
            weights=tuple(self.dev.weights0),
            tr_plus=torch.zeros((n_p,), **zeros),
            tr_minus=torch.zeros((n_p,), **zeros),
        )

    def run(
        self,
        state: Dict,
        steps: int,
        *,
        record_raster: Optional[bool] = None,
        record_v: Optional[bool] = None,
    ) -> Tuple[Dict, Dict]:
        """Advance ``steps`` steps; returns ``(state', outs)`` with ``outs``
        on the run's device: ``spike_count`` ``(steps,)`` int32, ``overflow``
        ``(steps,)`` int32 zeros (the identity exchange drops nothing), and,
        when recorded, ``raster`` ``(steps, n_p)`` uint8 and ``v_mean``
        ``(steps,)`` f32.  The recordings default to the ``SimConfig``."""
        if record_raster is None:
            record_raster = self.cfg.record_raster
        if record_v is None:
            record_v = self.cfg.record_v
        carry = dict(state)
        for key in ("vtx_state", "ring", "hist", "tr_plus", "tr_minus"):
            carry[key] = state[key].clone()
        if self.dev.any_plastic:  # the weights change only on plastic nets
            carry["weights"] = tuple(w.clone() for w in state["weights"])
        carry["_reduce"] = state_reduce(self.dev, carry["weights"])
        carry["t"] = int(state["t"])
        on = dict(device=self.device)
        outs = dict(
            spike_count=torch.empty(steps, dtype=torch.int32, **on),
            overflow=torch.zeros(steps, dtype=torch.int32, **on),
        )
        if record_raster:
            outs["raster"] = torch.empty(
                (steps, self.dev.n_p), dtype=torch.uint8, **on
            )
        if record_v:
            outs["v_mean"] = torch.empty(steps, dtype=torch.float32, **on)
        for j in range(steps):
            spikes = self._step(carry)
            outs["spike_count"][j] = spikes.sum()
            if "raster" in outs:
                outs["raster"][j] = spikes
            if "v_mean" in outs:
                outs["v_mean"][j] = carry["vtx_state"][:, LIF_V].mean()
        del carry["_reduce"]
        return carry, outs

    # -- dCSR sync (simulation state -> serializable network) -------------
    def state_to_dcsr(self, state: Dict) -> None:
        """Write simulation state back into the dCSR partition in place
        (weights via ELL edge_index, vertex tuples directly)."""
        part = self.net.parts[0]
        part.vtx_state = state["vtx_state"].cpu().numpy()
        self.ell.update_bucket_weights([w.cpu().numpy() for w in state["weights"]])
        self.ell.scatter_weights_back(part)

    def runtime_state(self, state: Dict) -> Dict[int, Dict[str, np.ndarray]]:
        """In-flight runtime arrays (ring/hist/traces) keyed per partition.
        On the CPU they are views of the carry: a snapshot copies them."""
        return {0: {k: state[k].cpu().numpy() for k in RUNTIME_KEYS if k in state}}

    def load_runtime(self, state: Dict, sim_state: Dict[int, Dict[str, np.ndarray]]) -> Dict:
        """``state`` with a snapshot's runtime arrays; a k > 1 snapshot's
        partitions are concatenated (partition order is the merged
        labelling)."""
        return load_runtime_arrays(state, concat_runtime(sim_state), "Simulator.load_runtime")
