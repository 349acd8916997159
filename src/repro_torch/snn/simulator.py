"""Clock-driven SNN simulator over one dCSR partition (k = 1), in torch.

Counterpart of ``repro/snn/simulator.py`` for the ``fused``,
``fused_plastic``, ``fused_event`` and ``unfused`` engines.  One step, in
the reference's documented order:

  1. deliver: ``i_syn = ring[t % D]``; clear that slot.
  2. neuron update with ``i_syn + noise(t, permanent id) + bias`` -> spikes;
     on plastic nets both e-traces decay, ``x' = x * exp(-dt/tau) + s``.
  3. propagate: per delay bucket b in order,
     ``ring[(t + d_b) % D] += spike_gather(spikes, cols_b, w_b)[:n_p]``;
     on plastic nets the bucket's STDP update follows its gather, from the
     weights the gather read.
  4. history: ``hist[t % D] = spikes``; ``t += 1``.

The ``fused`` engine does 2 and the gathers of 3 in one cooperative kernel
launch, and ``fused_plastic`` also the trace decays and the STDP updates;
``fused_event`` launches ``lif_step`` and then one cooperative kernel that
clears the slot of 1 and gathers only the row blocks the step's spikes
touch; ``unfused`` launches ``lif_step`` and then one ``spike_gather`` per
bucket, and on plastic nets decays the traces as torch ops and launches one
``stdp_update`` per bucket.  All go through the same device routines, so
their rasters, traces and weights are bit-identical on the card, and
through the same plain versions on the CPU.  Plastic nets never take the
event gather (``dispatch.event_gather_blocker``).

``lax.scan`` becomes a Python loop over steps with no host sync inside a
run: spike counts, raster rows and ``v_mean`` go into tensors preallocated
on the run's device and are copied to the host once, by the caller.  The
carry's tensors are updated in place after ``run`` has copied them (the
weights too, on plastic nets), so the state a caller passes in is never
changed.

``SimConfig(gather="auto")``, the default, starts on the dense gather and
lets ``Session``'s chunk loop switch to the event-driven engine
(``fused_event``: ``lif_step`` plus one event-gather launch, see
``kernels/event_step.py``) while the running spike rate stays under
``EVENT_ACTIVITY_THRESHOLD``, as the reference does.  The engines give
identical rasters, so the switch never changes a trajectory.

Noise is a pure function of (seed, t, permanent neuron id): a generator on
the run's device, seeded from (seed, t), draws the ``(n_global,)`` normals,
and each row takes the value of its permanent id.  The reference draws
with ``jax.random``, which torch cannot reproduce, so cross-package tests
inject the reference's noise through the ``_noise_fn`` seam of
:class:`Simulator`.
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
    StepEngineChoice, backend_for, resolve_device, select_step_engine,
)
from ..kernels.event_step import EventPlan, event_id_cap
from .neurons import LIF_BIAS, LIF_PARAM_KEYS, LIF_REF, LIF_V, make_neuron_step

# in-flight runtime arrays of the carry (the serialization side-channel)
RUNTIME_KEYS = ("ring", "hist", "tr_plus", "tr_minus")


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
        if self.exchange == "index":
            raise _not_ported("SimConfig(exchange='index')", "k>1 engine")
        if self.overlap not in ("auto", "off"):
            raise _not_ported(f"SimConfig(overlap={self.overlap!r})", "k>1 engine")
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
    weights and no other engine reads them."""

    n_p: int
    vtx_model: torch.Tensor
    vtx_state0: torch.Tensor
    delays: Tuple[int, ...]
    cols: List[torch.Tensor]  # per bucket (R, K) int32 (global ids)
    weights0: List[torch.Tensor]  # per bucket (R, K) f32
    identity_rows: Tuple[bool, ...]
    # per bucket (R, K) f32 0/1 mask of the syn_stdp slots; None when the
    # partition has no plastic synapse
    plastic: Optional[List[torch.Tensor]] = None

    @property
    def any_plastic(self) -> bool:
        return self.plastic is not None


def partition_device_data(
    part: DCSRPartition, ell: DelayELL, device: torch.device, stdp_id: int
) -> PartitionDeviceData:
    for b in ell.buckets:
        # the kernels read act[cols] without a bounds check
        if b.cols.size and not 0 <= int(b.cols.min()) <= int(b.cols.max()) < ell.n_global:
            raise ValueError(
                f"delay-{b.delay} panel has col ids outside [0, {ell.n_global})"
            )
    plastic = None
    if np.any(part.edge_model == stdp_id):
        plastic = []
        for b in ell.buckets:  # repro/snn/simulator.py:174-185
            is_stdp = np.zeros(b.cols.shape, dtype=np.float32)
            sel = b.edge_index >= 0
            is_stdp[sel] = part.edge_model[b.edge_index[sel]] == stdp_id
            plastic.append(torch.from_numpy(is_stdp).to(device))
    return PartitionDeviceData(
        n_p=part.n,
        vtx_model=torch.from_numpy(part.vtx_model).to(device),
        vtx_state0=torch.from_numpy(part.vtx_state).to(device),
        delays=tuple(b.delay for b in ell.buckets),
        cols=[torch.from_numpy(b.cols).to(device) for b in ell.buckets],
        weights0=[torch.from_numpy(b.weights).to(device) for b in ell.buckets],
        identity_rows=tuple(b.identity_rows for b in ell.buckets),
        plastic=plastic,
    )


def _models_present(net: DCSRNetwork) -> Tuple[str, ...]:
    names = []
    for i, spec in enumerate(net.registry.vertex_models()):
        if any(np.any(p.vtx_model == i) for p in net.parts):
            names.append(spec.name)
    return tuple(names)


_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64's finalizer: every output bit depends on every input bit."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _step_seed(seed: int, t: int) -> int:
    """The noise generator's seed for step ``t``: a pure function of
    (seed, t), mixed so that its low 32 bits (all that the CPU generator
    keeps) depend on both."""
    return _mix64(_mix64(seed & _MASK64) ^ (t & _MASK64))


def make_core_step(
    *,
    registry,
    models_present: Sequence[str],
    dt: float,
    noise_sigma: float,
    seed: int,
    d_ring: int,
    n_global: int,
    dev: PartitionDeviceData,
    noise_ids: torch.Tensor,
    engine_choice: StepEngineChoice,
    stdp_params: Optional[Dict[str, float]] = None,
    event_plan: Optional[EventPlan] = None,
    noise_fn: Optional[Callable[[int], object]] = None,
) -> Callable:
    """The per-partition step: ``step(carry)`` advances ``carry`` in place
    by one step and returns the step's spike vector.

    ``engine_choice`` comes from ``dispatch.select_step_engine``; the event
    engine needs the partition's ``event_plan``.  ``stdp_params`` are the
    registry's ``syn_stdp`` params, needed on plastic partitions (those
    whose ``dev.plastic`` is set).  ``noise_ids`` are the
    permanent neuron ids of the local rows.  ``noise_fn(t)``, when given,
    supplies the ``(n_global,)`` noise of step ``t`` (already scaled by
    sigma) in place of the port's own generator."""
    D = d_ring
    n_p = dev.n_p
    device = dev.vtx_state0.device
    choice = engine_choice
    if choice.event and event_plan is None:
        raise ValueError("the fused_event engine needs the partition's EventPlan")
    plastic = dev.any_plastic
    if plastic and stdp_params is None:
        raise ValueError("a plastic partition needs the syn_stdp params")
    if choice.plastic != plastic and choice.engine != "unfused":
        raise ValueError(f"the {choice.engine} engine does not fit a "
                         f"{'plastic' if plastic else 'non-plastic'} partition")
    taus = (stdp_params["tau_plus"], stdp_params["tau_minus"]) if plastic else None
    if choice.fused:
        neuron_step = None
        lif_p = dict(registry.spec("lif").params)
        lif_params = {"dt": dt, **{k: lif_p[k] for k in LIF_PARAM_KEYS}}
    else:
        neuron_step = make_neuron_step(registry, models_present, dt)
    gen = torch.Generator(device=device) if noise_sigma > 0 else None

    def noise(t: int) -> Optional[torch.Tensor]:
        if noise_fn is not None:
            noise_g = torch.tensor(
                np.asarray(noise_fn(t)), dtype=torch.float32, device=device
            )
        elif gen is not None:
            gen.manual_seed(_step_seed(seed, t))
            noise_g = noise_sigma * torch.randn(
                n_global, generator=gen, dtype=torch.float32, device=device
            )
        else:
            return None
        return noise_g.index_select(0, noise_ids)

    def step(carry: Dict) -> torch.Tensor:
        t = carry["t"]
        slot = t % D
        ring = carry["ring"]
        i_syn = ring[slot].clone()
        if not choice.event:  # the event kernel clears the slot itself
            ring[slot] = 0.0
        n_t = noise(t)
        if n_t is not None:
            i_syn = i_syn + n_t
        vtx = carry["vtx_state"]
        currents = ()
        if choice.engine == "fused":
            # one cooperative launch: LIF advance + spike emission + every
            # bucket's gather from the fresh spike vector
            i_tot = i_syn + vtx[:, LIF_BIAS]
            v2, r2, spikes, currents = ops.fused_step(
                vtx[:, LIF_V].contiguous(), vtx[:, LIF_REF].contiguous(),
                i_tot, dev.cols, carry["weights"], params=lif_params,
            )
            vtx[:, LIF_V] = v2
            vtx[:, LIF_REF] = r2
        elif choice.plastic:
            # one cooperative launch: LIF advance + both trace decays, then
            # per bucket the gather from the pre-update weights and the
            # masked STDP update (identity exchange: the pre-spike is the
            # spike vector, the pre-trace tr_plus')
            i_tot = i_syn + vtx[:, LIF_BIAS]
            (v2, r2, spikes, carry["tr_plus"], carry["tr_minus"], currents,
             new_weights) = ops.fused_step_plastic(
                vtx[:, LIF_V].contiguous(), vtx[:, LIF_REF].contiguous(), i_tot,
                carry["tr_plus"], carry["tr_minus"], dev.cols, carry["weights"],
                dev.plastic, params=lif_params, taus=taus, stdp=stdp_params,
            )
            vtx[:, LIF_V] = v2
            vtx[:, LIF_REF] = r2
            carry["weights"] = tuple(new_weights)
        elif choice.event:
            # LIF advance, then one launch that compresses the spikes to
            # ids, flags the touched row blocks and adds only their gathers
            # to the ring (the delivered slot cleared first)
            i_tot = i_syn + vtx[:, LIF_BIAS]
            v2, r2, spikes = ops.lif_step(
                vtx[:, LIF_V].contiguous(), vtx[:, LIF_REF].contiguous(),
                i_tot, params=lif_params,
            )
            vtx[:, LIF_V] = v2
            vtx[:, LIF_REF] = r2
            ops.event_post_exchange(
                spikes, ring, slot, [(t + d) % D for d in dev.delays],
                event_plan, dev.cols, carry["weights"],
            )
        else:
            new_vtx, spikes = neuron_step(dev.vtx_model, vtx, i_syn)
            vtx.copy_(new_vtx)
            if plastic:
                # the trace decays as torch ops, as the reference runs them
                # as jnp outside any kernel
                tr_plus = ref.trace_decay_ref(carry["tr_plus"], spikes, dt=dt, tau=taus[0])
                tr_minus = ref.trace_decay_ref(carry["tr_minus"], spikes, dt=dt, tau=taus[1])
                carry["tr_plus"], carry["tr_minus"] = tr_plus, tr_minus
                pad_r = dev.cols[0].shape[0] - n_p  # rows >= n_p: post terms 0
                post_t = torch.nn.functional.pad(tr_minus, (0, pad_r))
                post_s = torch.nn.functional.pad(spikes, (0, pad_r))
            for i, (c, w, d) in enumerate(zip(dev.cols, carry["weights"], dev.delays)):
                ring[(t + d) % D] += ops.spike_gather(spikes, c, w)[:n_p]
                if plastic:
                    # in place: run() cloned the weights, and the gather
                    # above read them first
                    ops.stdp_update(w, dev.plastic[i], c, tr_plus, spikes, post_t,
                                    post_s, params=stdp_params, out=w)
        for cur, d in zip(currents, dev.delays):
            ring[(t + d) % D] += cur[:n_p]
        carry["hist"][slot] = spikes.to(torch.uint8)
        carry["t"] = t + 1
        return spikes

    step.engine_choice = choice
    return step


class Simulator:
    """Single-partition (k = 1) step engine behind :class:`Session`.

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
            fused=self.cfg.fused,
            gather=gather,
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

    def set_gather(self, gather: str) -> None:
        """Run the next steps with the ``"dense"`` or ``"event"`` gather."""
        if gather not in self._steps:
            choice = self._choice(gather)
            self._steps[gather] = make_core_step(
                registry=self.net.registry,
                models_present=self._models,
                dt=self.dt,
                noise_sigma=self.noise_sigma,
                seed=self.cfg.seed,
                d_ring=self.d_ring,
                n_global=self.net.n,
                dev=self.dev,
                noise_ids=self._noise_ids,
                engine_choice=choice,
                stdp_params=self.stdp_params,
                event_plan=self.event_plan if choice.event else None,
                noise_fn=self._noise_fn,
            )
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
        """In-flight runtime arrays (ring/hist/traces) keyed per partition."""
        return {0: {k: state[k].cpu().numpy() for k in RUNTIME_KEYS if k in state}}
