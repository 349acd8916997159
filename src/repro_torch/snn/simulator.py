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
     on plastic nets every bucket's STDP update follows the gathers, from
     the weights they read (a gather reads only its own bucket's weights,
     so this is the reference's bucket-by-bucket order, bit for bit).
  5. history: ``hist[t % D] = spikes``; ``t += 1`` (on the device).

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
torch ops and launches one ``stdp_update`` over every bucket
(``ops.stdp_update_step``: the rows of the upload's ``stdp_plan``, their
post terms read in the kernel).  All go through the
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

``jax.jit`` over ``lax.scan`` becomes a compiled chunk: the carry's ``t``
is a 0-d int64 tensor on the run's device, as in the reference's scan
carry, and every op of a step reads it there (the kernels through a
pointer; the ring rows ``t % D`` and ``(t + d) % D``, the history row and
the split engines' clear and one-hot rows through index ops on device
indices), so no step turns ``t`` into a host int.  On the card a run of
``c`` steps replays one CUDA graph per step engine, ``c`` and recordings
(:class:`ChunkGraphs`), captured the first time, at any ``t``; elsewhere
the same steps run as a Python loop (:func:`graph_mode`).  Spike counts,
raster rows and ``v_mean`` go into tensors on the run's device, copied to
the host once a chunk by the caller.  The carry's tensors are updated in
place after ``run`` has copied them (the weights too, on plastic nets), so
the state a caller passes in is never changed, and what a run returns is
its caller's: no later run changes it.

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
import gc
import os
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.dcsr import DCSRNetwork, DCSRPartition
from ..core.ell import DelayELL, ELLBucket, build_delay_ell
from ..core.state import EDGE_DELAY, EDGE_WEIGHT
from ..kernels import _build, ops, ref
from ..kernels.dispatch import (
    StepEngineChoice, backend_for, panel_reduce, resolve_device, select_step_engine,
)
from ..kernels.event_step import EventPlan, event_id_cap
from ..kernels.segment_gather import SegmentPlan, segment_plan
from ..kernels.stdp_update import StdpStepPlan, stdp_step_plan
from .neurons import LIF_BIAS, LIF_PARAM_KEYS, LIF_REF, LIF_V, make_neuron_step
from .reshard import RUNTIME_KEYS, concat_runtime


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """User-facing simulation knobs (the reference's fields and checks).

    ``max_k`` splits rows wider than it into virtual rows (the k = 1
    engine's ELL, ``core/ell.py``; k > 1 ignores it, as the reference
    does), which takes the ``unfused`` engine: a step's gathers, each row's
    virtual rows added and the ring add are one ``ops.segment_gather_ring``.
    There is no ``backend`` field: the run's device decides between the CUDA
    kernels and the plain versions."""

    fused: Optional[bool] = None  # None=auto, True=require fused step, False=off
    align_k: int = 128
    align_rows: int = 8
    max_k: Optional[int] = None  # heavy-row split cap (single-partition only)
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
    # per bucket of a heavy-row split (SimConfig(max_k=...)), whose panel
    # rows are virtual rows: the (n_p + 1,) int32 offsets of each real row's
    # virtual rows; None for a bucket of real rows
    row_ptr: Optional[List[Optional[torch.Tensor]]] = None
    # the split step's tiles over every bucket's virtual rows
    # (ops.segment_gather_ring); None when no bucket is split
    segment: Optional[SegmentPlan] = None
    # the unfused step's STDP work (ops.stdp_update_step): the rows holding
    # a plastic slot, their real slots and post rows (a split bucket's
    # row_map); None when the partition has no plastic synapse
    stdp_plan: Optional[StdpStepPlan] = None
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


def split_row_ptr(row_map: np.ndarray, n_p: int) -> np.ndarray:
    """The ``(n_p + 1,)`` int32 offsets of each real row's virtual rows in a
    split bucket: ``core/ell.py`` gives row ``r`` one virtual row or more,
    contiguous and ascending (``row_map[:R_v]`` is nondecreasing), and maps
    the padding rows ``R_v:`` to row 0; they hold no slot and are left out
    (at ``n_p = 1`` they stay in row 0's range, where they add ``+0.0``, as
    the reference's ``segment_sum`` adds them)."""
    r_v = int(np.flatnonzero(row_map == n_p - 1).max()) + 1 if n_p else 0
    counts = np.bincount(row_map[:r_v], minlength=n_p)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def partition_device_data(
    part: DCSRPartition, ell: DelayELL, device: torch.device, stdp_id: int
) -> PartitionDeviceData:
    plastic = plastic_masks(part, ell, stdp_id)
    weights0 = [torch.from_numpy(b.weights).to(device) for b in ell.buckets]
    split = not all(b.identity_rows for b in ell.buckets)
    ptrs = [None if b.identity_rows else split_row_ptr(b.row_map, part.n) for b in ell.buckets]
    row_len = row_lengths([b.valid for b in ell.buckets], device)
    return PartitionDeviceData(
        n_p=part.n,
        vtx_model=torch.from_numpy(part.vtx_model).to(device),
        vtx_state0=torch.from_numpy(part.vtx_state).to(device),
        delays=tuple(b.delay for b in ell.buckets),
        cols=checked_cols([b.cols for b in ell.buckets], ell.n_global, "delay-bucket", device),
        weights0=weights0,
        row_len=row_len,
        reduce=panel_reduce(weights0, plastic is not None),
        identity_rows=tuple(b.identity_rows for b in ell.buckets),
        plastic=None if plastic is None else [torch.from_numpy(m).to(device) for m in plastic],
        row_ptr=[None if p is None else torch.from_numpy(p).to(device) for p in ptrs]
        if split else None,
        segment=segment_plan(ptrs, [b.cols.shape[1] for b in ell.buckets], part.n, device)
        if split else None,
        stdp_plan=None if plastic is None else stdp_step_plan(
            plastic, row_len, [None if b.identity_rows else b.row_map for b in ell.buckets],
            part.n, device),
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


TOPOLOGY_FIELDS = (
    "row_ptr", "col_idx", "vtx_model", "edge_model", "coords", "global_ids",
)


def same_engine_inputs(old: DCSRNetwork, new: DCSRNetwork, plastic: bool) -> bool:
    """Whether an engine built from ``old`` computes ``new`` as it stands:
    the same partitions, topology (``TOPOLOGY_FIELDS``), delays, models,
    meta and, on a non-plastic net, weights.  Vertex state and plastic
    weights may differ: they are the carry's, not the engine's."""
    if (old.k != new.k or old.n != new.n or old.m != new.m
            or not np.array_equal(old.dist, new.dist) or old.meta != new.meta
            or old.registry.to_entries() != new.registry.to_entries()):
        return False
    for po, pn in zip(old.parts, new.parts):
        if any(not np.array_equal(getattr(po, f), getattr(pn, f)) for f in TOPOLOGY_FIELDS):
            return False
        cols = [EDGE_DELAY] if plastic else [EDGE_DELAY, EDGE_WEIGHT]
        if not np.array_equal(po.edge_state[:, cols], pn.edge_state[:, cols]):
            return False
    return True


def bucket_weights(bucket: ELLBucket, part: DCSRPartition) -> np.ndarray:
    """A bucket's ``(R, K)`` weight panel read from the partition's
    ``edge_state`` through its ``edge_index`` (0 in the padding): the
    inverse of ``DelayELL.scatter_weights_back``."""
    w = np.zeros(bucket.weights.shape, np.float32)
    sel = bucket.edge_index >= 0
    w[sel] = part.edge_state[bucket.edge_index[sel], EDGE_WEIGHT]
    return w


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
    """The split engines' slot arithmetic as device tables, one row per
    ``t % D``: ``clear[t % D]`` is the ``(D,)`` mask with 0 at the delivered
    slot, ``onehot[t % D]`` the ``(nd, D)`` one-hot of each bucket's write
    slot ``(t + d) % D`` (``repro/snn/simulator.py:420-431``)."""
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
    slice zeroed, and ``own``, that slice's ids ``(lo, hi)`` (the plastic
    remote pass zeroes them in its kernel).  With ``double_buffer`` the
    carry holds a ``_pending`` entry (step t's deferred remote pass),
    applied at the top of step t+1 and by ``step.pending_flush(carry)``,
    which a run calls at its end."""
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
    if choice.split:
        # one (D, D + nd * D) table: a row holds the clear mask and the
        # one-hots of its t % D, so one index_select fetches both
        clear_tab, onehot_tab = slot_tables(D, dev.delays, device)
        slot_tab = torch.cat([clear_tab, onehot_tab.reshape(D, -1)], dim=1)
    # t % D, then per bucket (t + d) % D: added to the device t once a step
    offsets = torch.tensor([0, *dev.delays], dtype=torch.int64, device=device)

    def step_slots(carry: Dict) -> torch.Tensor:
        """The ``(1 + nd,)`` int64 ring rows of the step on the device:
        ``t % D``, then each bucket's ``(t + d) % D``; made once a step and
        dropped by ``post``."""
        idx = carry.get("_slots")
        if idx is None:
            idx = carry["_slots"] = torch.remainder(carry["t"] + offsets, D)
        return idx

    def slot_masks(carry: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """The split kernels' ``(D,)`` clear mask and ``(nd, D)`` one-hots
        of the step, one row of ``slot_tab`` picked on the device."""
        row = slot_tab.index_select(0, step_slots(carry)[:1])[0]
        return row[:D], row[D:].view(len(dev.delays), D)

    def add_to_ring(ring: torch.Tensor, row: torch.Tensor, cur: torch.Tensor) -> None:
        """``ring[row] += cur[:n_p]``, ``row`` a ``(1,)`` index on the
        device: one f32 add per element, as the reference's
        ``ring.at[slot].add``.  On the card ``index_add_`` (one kernel); on
        the CPU the same add through ``index_put_``, since the CPU's
        ``index_add_`` starts every core's thread for one row."""
        if ring.is_cuda:
            ring.index_add_(0, row, cur[:n_p].unsqueeze(0))
        else:
            ring.index_put_((row,), cur[:n_p].unsqueeze(0), accumulate=True)

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
            # the gather reads act with the own slice as 0, in the kernel;
            # the weights are updated in place in the carry's
            ops.fused_post_exchange_remote_plastic(
                None, pend["act"], pend["pre_trace"], ring, pend["onehot"],
                pend["post_trace"], pend["post_spike"], dev.cols, carry["weights"],
                dev.plastic, dev.row_len, stdp=stdp_params, out=ring, own=overlap_ctx["own"],
                weights_out=carry["weights"],
            )
        elif choice.event:
            # the slots of the pending step's t, no clear
            ops.event_post_exchange(
                overlap_ctx["mask_remote"](pend["act"]), ring, pend["t"], dev.delays,
                event_plan, dev.cols, carry["weights"], dev.row_len, reduce=carry["_reduce"],
                clear=False,
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
        idx = step_slots(carry)
        ring = carry["ring"]
        vtx = carry["vtx_state"]
        # the delivered slot, a new tensor
        x = ring.index_select(0, idx[:1])[0]
        # i_syn + noise (+ bias on the fused engines, whose neuron step is
        # inside their kernel)
        bias = vtx[:, LIF_BIAS] if choice.fused else None
        if own_noise:
            i_in = ops.step_noise_add(x, noise_ids, seed, t, noise_sigma, bias)
        else:
            i_in = x if noise_g is None else x + noise_g.to(device).index_select(0, noise_ids)
            if bias is not None:
                i_in += bias
        if not (choice.split or choice.event):
            # the split and event kernels rotate the ring themselves
            ring.index_fill_(0, idx[:1], 0.0)
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
            for b, cur in enumerate(currents):
                add_to_ring(ring, idx[1 + b:2 + b], cur)
        elif choice.engine == "fused_plastic":
            # one cooperative launch: LIF advance + both trace decays, then
            # per bucket and row, over its real slots, the gather from the
            # pre-update weights, the masked STDP update in place in the
            # carry's weights (identity exchange: the pre-spike is the spike
            # vector, the pre-trace tr_plus') and the add into
            # ring[(t + d) % D]
            v2, r2, spikes, carry["tr_plus"], carry["tr_minus"], _, _ = ops.fused_step_plastic(
                v, refrac, i_in, carry["tr_plus"], carry["tr_minus"], dev.cols,
                carry["weights"], dev.plastic, dev.row_len, params=lif_params, taus=taus,
                stdp=stdp_params, ring=ring, t=t, delays=dev.delays,
                weights_out=carry["weights"],
            )
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
        ring = carry["ring"]
        if use_front:
            # one launch: the noise and the bias added to the delivered slot
            # (the ring's row t % D, read in place: the split and event
            # kernels rotate the ring later in the step), LIF in place in
            # vtx_state, the history row hist[t % D] (and both trace decays,
            # as new tensors: post's pending record keeps tr_minus); the
            # kernel picks both rows from the device t
            x = ring if noise_g is None else (
                ring.index_select(0, step_slots(carry)[:1])[0]
                + noise_g.to(device).index_select(0, noise_ids))
            spikes, *traces = ops.step_front(
                carry["vtx_state"], x, noise_ids, seed=seed, t=t, sigma=noise_sigma,
                draw=own_noise, bias=True, hist_row=carry["hist"],
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
            # delivered slot cleared first); the slots from t, on the card
            ops.event_post_exchange(
                spikes, ring, t, dev.delays, event_plan, dev.cols, carry["weights"],
                dev.row_len, reduce=carry["_reduce"],
            )
        return spikes, carry["tr_plus"]

    def post(carry: Dict, spikes: torch.Tensor, act: torch.Tensor, pre_trace: torch.Tensor) -> None:
        """Propagate the exchanged activity into the ring (and learn), then
        record the history and advance ``t``."""
        t = carry["t"]
        ring = carry["ring"]
        weights = carry["weights"]
        if (choice.split and choice.engine != "fused_split_event") or overlap_on:
            clear, onehot = slot_masks(carry)
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
            # t is never changed in place (the step ends with t + 1), so the
            # record keeps this step's
            pend = dict(act=act, onehot=onehot, t=t)
            if choice.plastic:
                pend.update(pre_trace=pre_trace, post_trace=carry["tr_minus"], post_spike=spikes)
            carry["_pending"] = pend
            if choice.overlap == "local":
                apply_pending(carry)
        elif choice.engine == "fused_split":
            ops.fused_post_exchange(act, ring, clear, onehot, dev.cols, weights, dev.row_len,
                                    reduce=carry["_reduce"], out=ring)
        elif choice.engine == "fused_split_event":
            ops.event_post_exchange(act, ring, t, dev.delays, event_plan, dev.cols, weights,
                                    dev.row_len, reduce=carry["_reduce"])
        elif choice.engine == "fused_split_plastic":
            ops.fused_post_exchange_plastic(
                act, pre_trace, ring, clear, onehot, carry["tr_minus"], spikes, dev.cols,
                weights, dev.plastic, dev.row_len, stdp=stdp_params, out=ring,
                weights_out=weights,
            )
        elif not choice.fused:
            split = dev.segment is not None
            if split:
                # every bucket's gather, each row's virtual rows added (the
                # reference's segment_sum) and the ring add in one op, from
                # the weights before this step's updates below
                ops.segment_gather_ring(act, ring, t, dev.delays, dev.segment, dev.cols, weights,
                                        dev.row_len, dev.row_ptr, reduce=carry["_reduce"])
            else:
                idx = step_slots(carry)
                for i, (c, w) in enumerate(zip(dev.cols, weights)):
                    add_to_ring(ring, idx[1 + i:2 + i],
                                ops.spike_gather(act, c, w, dev.row_len[i],
                                                 reduce=carry["_reduce"][i:i + 1]))
            if plastic:
                # every bucket's update in one op, in place (run() cloned
                # the weights), after every gather: a gather reads only its
                # own bucket's weights; the post terms of each row (0 past
                # n_p, a split bucket's through its row_map) in the op
                ops.stdp_update_step(weights, dev.plastic, dev.cols, pre_trace, act,
                                     carry["tr_minus"], spikes, plan=dev.stdp_plan,
                                     params=stdp_params)
        if not use_front:  # the front wrote it
            carry["hist"].index_copy_(0, step_slots(carry)[:1], spikes.to(torch.uint8)[None])
        carry.pop("_slots", None)
        carry["t"] = t + 1

    def step(carry: Dict, noise_g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One k = 1 step.  With the ``_noise_fn`` seam, ``noise_g`` is the
        step's ``(n_global,)`` noise, which the run loop draws at the
        host's step (``step.seam(t)``); given none, the step draws it
        itself, reading ``t`` back to the host."""
        if seam_noise is not None and noise_g is None:
            noise_g = seam_noise(int(carry["t"]))
        spikes, tr_plus = pre(carry, noise_g)
        post(carry, spikes, spikes, tr_plus)  # the identity exchange
        return spikes

    def pending_flush(carry: Dict) -> None:
        """Apply and drop a trailing ``_pending`` entry (the run's end)."""
        apply_pending(carry)

    step.engine_choice = choice
    step.pre = pre
    step.post = post
    step.pending_flush = pending_flush
    # the seam's noise of step t (a host int), None with the port's own
    step.seam = seam_noise
    return step


# carry entries the run copies: updated in place or replaced by every step
# (the weights too, on plastic nets)
STATE_KEYS = ("vtx_state", "ring", "hist", "tr_plus", "tr_minus")


def copy_carry(state: Dict, device, plastic: bool) -> Dict:
    """A run's own carry from a caller's state: the state tensors cloned
    (the weights too on plastic nets, whose steps change them; a
    non-plastic net's are only read), ``t`` as the 0-d int64 tensor on
    ``device``, so the caller's state is never changed."""
    carry = dict(state)
    for key in STATE_KEYS:
        carry[key] = state[key].clone()
    if plastic:
        carry["weights"] = tuple(w.clone() for w in state["weights"])
    # an int t (a state made elsewhere) is copied to the device
    carry["t"] = torch.as_tensor(state["t"], dtype=torch.int64, device=device).clone()
    return carry


def graph_failure(what: str, err: BaseException) -> RuntimeError:
    """The error a failed capture raises: the chunk, and the innermost
    line of the port that was running (the op that broke the capture)."""
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if f"{os.sep}repro_torch{os.sep}" in f.filename]
    where = (f"{os.path.basename(frames[-1].filename)}:{frames[-1].lineno} "
             f"({frames[-1].line})" if frames else "outside the port")
    return RuntimeError(f"CUDA graph capture of {what} failed at {where}: "
                        f"{type(err).__name__}: {err}")


def graph_mode(device_type: str, graphs: bool, seam: bool, cards: int = 1) -> str:
    """``"cuda_graph"`` when a run replays CUDA graphs, else why it runs the
    uncaptured loop: on the CPU, with the ``_noise_fn`` seam, with
    ``_graphs=False``, or with partitions on more than one card (which waits
    for ``torch.distributed``, ROADMAP queue 1)."""
    if device_type != "cuda":
        return "uncaptured: the CPU"
    if not graphs:
        return "uncaptured: _graphs=False"
    if seam:
        return "uncaptured: the _noise_fn seam"
    if cards > 1:
        return "uncaptured: partitions on more than one card"
    return "cuda_graph"


@dataclasses.dataclass
class ChunkGraph:
    """One captured chunk: its graph, the carries it reads at its start
    (``static``, which a replay first overwrites with the caller's state),
    the carries and outputs it leaves in its memory pool, the launches its
    capture counted (per ``_build.COUNTERS``), and its set-up seconds."""

    graph: "torch.cuda.CUDAGraph"
    static: List[Dict]
    carries: List[Dict]
    outs: Dict[str, torch.Tensor]
    launches: List[int]
    what: str
    steps: int
    warmup_s: float
    capture_s: float
    instantiate_s: float
    replays: int = 0


class ChunkGraphs:
    """The compiled chunk on the card: one ``torch.cuda.CUDAGraph`` per key,
    the counterpart of the reference's ``jax.jit`` over ``lax.scan`` with
    ``steps`` static (``repro/snn/simulator.py:788-790``,
    ``dist_sim.py:464-475``).

    A key is the step function (the engine of a gather mode, one step
    function a partition), the chunk's length, the recordings, and what the
    graph takes as it is from the caller's state rather than copying (the
    gathers' reduction, and a non-plastic net's weights, read in place).
    The first run of a key warms the engine up on a scratch copy of the
    state (one step, uncaptured: the kernel library is loaded and each
    kernel's module and attributes set before the capture), then captures
    the whole chunk, steps, recordings and the trailing pending flush, into
    a graph in the simulator's one memory pool and instantiates it.  Every
    run of the key then copies the caller's state into the graph's input
    carries, replays the graph and clones what it leaves into new tensors
    that belong to the caller: a later replay never changes a returned
    state or output.  Since ``t`` and the ring rows live on the device, a
    graph replays at any ``t``.

    A capture that fails raises, naming the line of the port that broke
    it; nothing falls back to the uncaptured loop.  The warm-up and the
    capture run no step of the caller's: the launch counters are set back
    after them, and each replay adds the launches its capture counted, so
    the counters count the launches that ran for the caller."""

    def __init__(self, device: torch.device, plastic: bool):
        self.device = device
        self.plastic = plastic
        self.pool = None  # the one memory pool of every graph, made at the first capture
        self.graphs: Dict[tuple, ChunkGraph] = {}

    def run(self, key: tuple, states: List[Dict], chunk: Callable, steps: int, what: str):
        """``chunk(carries, n)`` runs ``n`` steps on the carries and returns
        ``(carries, outs)``; returns those of ``steps`` steps from
        ``states``, replayed from the key's graph."""
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(states, chunk, steps, what)
        for static, state in zip(g.static, states):
            for name in STATE_KEYS:
                static[name].copy_(state[name])
            if self.plastic:
                for w, w_in in zip(static["weights"], state["weights"]):
                    w.copy_(w_in)
            if torch.is_tensor(state["t"]):
                static["t"].copy_(state["t"])
            else:
                static["t"].fill_(int(state["t"]))
        g.graph.replay()
        for counter, n in zip(_build.COUNTERS, g.launches):
            counter.launches += n
        g.replays += 1
        return self._clone_out(g.carries), {k: v.clone() for k, v in g.outs.items()}

    def _clone_out(self, carries: List[Dict]) -> List[Dict]:
        out = []
        for c in carries:
            c = dict(c)
            for key in (*STATE_KEYS, "t"):
                c[key] = c[key].clone()
            if self.plastic:
                c["weights"] = tuple(w.clone() for w in c["weights"])
            out.append(c)
        return out

    def _capture(self, states: List[Dict], chunk: Callable, steps: int, what: str) -> ChunkGraph:
        counts = _build.launch_counts()
        t0 = time.perf_counter()

        def copies():
            return [copy_carry(s, self.device, self.plastic) for s in states]

        chunk(copies(), 1)  # the warm-up, on a scratch copy
        torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        static = copies()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        # keep_graph: the raw cudaGraph_t stays readable (its nodes are
        # counted by chip_smoke.py), and instantiation is timed on its own
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = _build.launch_counts()
        # the cyclic collector is off while the stream captures: a dead
        # cycle that holds another graph, collected mid-capture, would free
        # that graph (CUDAGraph.reset), which the capturing thread may not
        # do, and the capture would be invalidated
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                carries, outs = chunk([dict(c) for c in static], steps)
        except Exception as err:
            _build.set_launch_counts(counts)
            # a capture that died leaves its pool registered for allocation
            # (torch ends that in capture_end, which raised): end it, and
            # take a new pool for the next capture
            try:
                index = self.device.index
                torch._C._cuda_endAllocateToPool(
                    torch.cuda.current_device() if index is None else index, self.pool)
            except RuntimeError:  # capture_end had ended it
                pass
            self.pool = None
            raise graph_failure(what, err) from err
        finally:
            if collecting:
                gc.enable()
        t2 = time.perf_counter()
        graph.instantiate()
        t3 = time.perf_counter()
        launches = [a - b for a, b in zip(_build.launch_counts(), before)]
        _build.set_launch_counts(counts)
        return ChunkGraph(graph, static, carries, outs, launches, what, steps,
                          t1 - t0, t2 - t1, t3 - t2)

    def summary(self) -> List[Dict]:
        """Per captured key: its label, steps, set-up seconds and replays."""
        return [dict(what=g.what, steps=g.steps, warmup_s=g.warmup_s, capture_s=g.capture_s,
                     instantiate_s=g.instantiate_s, replays=g.replays)
                for g in self.graphs.values()]


class Simulator:
    """Single-partition (k = 1) step engine behind :class:`Session`; its
    exchange is the identity, so an explicit ``SimConfig(overlap=...)``
    resolves to ``"off"`` (and raises with ``fused=True``), as in the
    reference.

    ``device`` is where it runs: the card unless the caller names another
    (``device="cpu"`` runs the plain torch versions).  ``_noise_fn`` is the
    internal noise seam (see :func:`make_core_step`).  ``_share``, another
    ``Simulator`` of the same net, device, alignments, ``max_k`` and event
    cap, lends its host ELL, device panels and touch bitmaps instead of
    building them again (no engine writes into them; a plastic net's carry
    holds its own weights), so two configs can be compared on one build.

    On the card :meth:`run` replays one CUDA graph per step engine, chunk
    length and recordings (:class:`ChunkGraphs`), at any ``t``.  It runs
    the same step code uncaptured, a Python loop that launches each step's
    kernels and ops, on the CPU, with the ``_noise_fn`` seam (a host
    callable per step), and with ``_graphs=False``, the internal seam that
    keeps the uncaptured loop on the card as the graphs' oracle.
    :attr:`graph_mode` says which.

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
        _graphs: bool = True,
        _share: Optional["Simulator"] = None,
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
        layout = ("align_k", "align_rows", "max_k", "event_cap_frac")
        if _share is not None and (
                _share.net is not net or _share.device != self.device
                or any(getattr(_share.cfg, f) != getattr(cfg, f) for f in layout)):
            raise ValueError(f"_share needs the same net, device and {', '.join(layout)}")
        self.ell = build_delay_ell(
            part, net.n, align_k=cfg.align_k, align_rows=cfg.align_rows, max_k=cfg.max_k,
        ) if _share is None else _share.ell
        self.d_ring = max(self.ell.max_delay, 1)
        self.dev = partition_device_data(
            part, self.ell, self.device, net.registry.edge_id("syn_stdp")
        ) if _share is None else _share.dev
        # the registry's STDP params (repro/snn/simulator.py:734-738)
        self.stdp_params = (
            dict(net.registry.spec("syn_stdp").params) if self.dev.any_plastic else None
        )
        self._noise_ids = torch.from_numpy(part.global_ids).to(self.device)
        self._noise_fn = _noise_fn
        self._graphs_on = _graphs
        self._graphs = (ChunkGraphs(self.device, self.dev.any_plastic)
                        if _graphs and self.device.type == "cuda" else None)
        self._models = _models_present(net)
        self._steps: Dict[str, Callable] = {}
        self._event_plan: Optional[EventPlan] = None if _share is None else _share._event_plan
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

    @property
    def graph_mode(self) -> str:
        """How :meth:`run` steps: ``"cuda_graph"``, or why it runs the
        uncaptured loop."""
        return graph_mode(self.device.type, self._graphs_on, self._step.seam is not None)

    def init_state(self, t0: int = 0) -> Dict:
        """The carry at step ``t0``; its ``t`` is a 0-d int64 tensor on the
        run's device, as the reference's scan carry holds it."""
        n_p = self.dev.n_p
        zeros = dict(dtype=torch.float32, device=self.device)
        return dict(
            t=torch.tensor(int(t0), dtype=torch.int64, device=self.device),
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
        ``(steps,)`` f32.  The recordings default to the ``SimConfig``.
        The returned state and outputs are new tensors: the caller's state
        is never changed, and no later run changes what this one returned.
        On the card the chunk replays its CUDA graph (:attr:`graph_mode`)."""
        if record_raster is None:
            record_raster = self.cfg.record_raster
        if record_v is None:
            record_v = self.cfg.record_v
        step = self._step
        reduce = state_reduce(self.dev, state["weights"])

        def chunk(carries: List[Dict], n: int):
            (carry,) = carries
            carry["_reduce"] = reduce
            outs = self._loop(step, carry, n, record_raster, record_v)
            del carry["_reduce"]
            return [carry], outs

        if self.graph_mode != "cuda_graph":
            (carry,), outs = chunk([copy_carry(state, self.device, self.dev.any_plastic)], steps)
            return carry, outs
        key = (step, steps, record_raster, record_v, reduce,
               () if self.dev.any_plastic else tuple(w.data_ptr() for w in state["weights"]))
        (carry,), outs = self._graphs.run(key, [state], chunk, steps,
                                          f"{step.engine_choice.engine} x {steps}")
        return carry, outs

    def _loop(self, step: Callable, carry: Dict, steps: int, record_raster: bool,
              record_v: bool) -> Dict[str, torch.Tensor]:
        """``steps`` steps of ``step`` on ``carry``, in place; returns the
        recordings, on the run's device.  With the seam, its noise is drawn
        at the host's step, ``t`` read back once a chunk."""
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
        t0 = None if step.seam is None else int(carry["t"])
        for j in range(steps):
            spikes = step(carry, None if t0 is None else step.seam(t0 + j))
            outs["spike_count"][j] = spikes.sum()
            if "raster" in outs:
                outs["raster"][j] = spikes
            if "v_mean" in outs:
                outs["v_mean"][j] = carry["vtx_state"][:, LIF_V].mean()
        return outs

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

    def state_from_dcsr(self, net: DCSRNetwork, t0: int) -> Dict:
        """The inverse of :meth:`state_to_dcsr`: the carry at step ``t0``
        with ``net``'s vertex state and, on a plastic net, its weights put
        into ELL slot order; a non-plastic carry keeps the uploaded panels
        (the graphs read them in place).  ``net`` becomes the engine's host
        net, so its topology must be this engine's
        (:func:`same_engine_inputs`)."""
        part = net.parts[0]
        state = self.init_state(t0)
        state["vtx_state"] = torch.tensor(part.vtx_state, device=self.device)
        if self.dev.any_plastic:
            state["weights"] = tuple(torch.tensor(bucket_weights(b, part), device=self.device)
                                     for b in self.ell.buckets)
        self.net = net
        return state

    def load_runtime(self, state: Dict, sim_state: Dict[int, Dict[str, np.ndarray]]) -> Dict:
        """``state`` with a snapshot's runtime arrays; a k > 1 snapshot's
        partitions are concatenated (partition order is the merged
        labelling)."""
        return load_runtime_arrays(state, concat_runtime(sim_state), "Simulator.load_runtime")
