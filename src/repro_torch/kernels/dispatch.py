"""Backend registry and step-engine selection for the port's kernel layer.

Counterpart of ``repro/kernels/dispatch.py``.  Backends:

  * ``ref``  -- the plain torch versions (``kernels/ref.py``), for CPU
               tensors;
  * ``cuda`` -- the hand-written CUDA kernels, for CUDA tensors.

The backend follows the tensor's device: a CUDA tensor always takes the
kernel, and a CPU tensor the plain version.  This is the reverse of the
reference, which sends everything off the TPU to ``ref``.

``select_step_engine`` picks one of ``STEP_ENGINES``:

  * ``fused`` -- one cooperative launch per step (identity exchange, k=1);
  * ``fused_plastic`` -- the same launch with both trace decays and the
    STDP update of every panel;
  * ``fused_event`` -- the step front (``step_front``: noise, bias, LIF in
    place in ``vtx_state``, the history row) plus one cooperative
    event-gather launch;
  * ``fused_split`` -- the fusion split at the exchange (k>1):
    the step front, the exchange, then one ``post_exchange`` launch (ring
    rotate and every bucket's gather);
  * ``fused_split_plastic`` -- the step front with both trace
    decays, the exchange of spikes and pre-traces, then one
    ``post_exchange_plastic`` launch (ring, gathers and STDP);
  * ``fused_split_event`` -- the step front, the exchange, then the event
    gather over the exchanged activity;
  * ``unfused`` -- ``lif_step`` plus one ``spike_gather`` launch per delay
    bucket (one ``segment_gather`` launch with ``max_k``), and on plastic
    nets the trace decays as torch ops and one ``stdp_update`` launch
    (``ops.stdp_update_step``) over every bucket.

The split engines carry an overlap mode (``StepEngineChoice.overlap``):
``off`` runs the post-exchange pass after the exchange; ``local`` splits it
into a pass over the own partition's synapses and a remote pass behind the
exchange; ``double_buffer`` defers the remote pass of step t to the top of
step t+1.  ``overlap="auto"`` resolves to ``local`` on the ``cuda`` backend
and to ``off`` on ``ref``, as the reference resolves it per backend
(``local`` on its compiled kernels).

Each engine declares its contract in :data:`ENGINE_CONTRACTS` (exchanges a
step by exchange key, host syncs a step, where 8-byte ints may appear),
which ``repro_torch.analysis.contracts`` checks on every eligible
configuration.

The reference's VMEM budgets (``FUSED_*_MAX_N_P``,
``FUSED_SPLIT_*_MAX_N_GLOBAL``, the event id-buffer budget) have no
counterpart: the kernels keep nothing resident beyond what L2 holds on its
own, so the only limits are the ones the kernels really have (LIF-only, and
a 32-entry per-bucket argument table).  In particular the reference sends
plastic partitions of more than ``FUSED_PLASTIC_MAX_N_P`` (157,286) neurons
to ``unfused``, for its ten VMEM-resident state and trace vectors; the port
fuses them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

BACKENDS = ("ref", "cuda")

_REGISTRY: Dict[Tuple[str, str], Callable] = {}


def implementation(op: str, backend: str) -> Callable:
    """Decorator: record ``fn`` as the ``backend`` implementation of ``op``.
    Implementations of one op share a call signature."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")

    def deco(fn: Callable) -> Callable:
        _REGISTRY[(op, backend)] = fn
        return fn

    return deco


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another device.  With no card and no explicit device this raises; it
    never falls back to the CPU."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "torch versions on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def backend_for(device: torch.device) -> str:
    """``cuda`` for a CUDA device, ``ref`` for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return "cuda"
    if device.type == "cpu":
        return "ref"
    raise ValueError(f"no kernels for device type {device.type!r}")


def lookup(op: str, backend: str) -> Callable:
    from . import ops  # noqa: F401  (the implementations are recorded there)

    try:
        return _REGISTRY[(op, backend)]
    except KeyError:
        have = tuple(b for (o, b) in sorted(_REGISTRY) if o == op)
        raise KeyError(
            f"no implementation of kernel op {op!r} for backend {backend!r}; "
            f"available: {have or '(none)'}"
        ) from None


# -- the gathers' reduction: row_dot_active or row_dot ----------------------

# ``active``: the gather reads only the real slots (``row_len``) and only
# the weights of active sources (common.cuh:row_dot_active), which equals
# row_dot bit for bit when the weights are finite; ``row_dot``: every slot,
# the reference's result on any weights (NaN * 0 is NaN).
REDUCE_MODES = ("active", "row_dot")


def panel_reduce(weights: Sequence[torch.Tensor], plastic: bool = False) -> Tuple[str, ...]:
    """Per panel the reduction its gathers take, chosen once from the data
    when the panels are uploaded: ``active`` where the weights are all
    finite and never change, ``row_dot`` where a weight is not finite (so a
    NaN weight of a silent source gives the reference's NaN) or the weights
    are plastic (they change every step).  One ``isfinite().all()`` a
    non-plastic panel."""
    if plastic:
        return ("row_dot",) * len(weights)
    return tuple("active" if bool(torch.isfinite(w).all()) else "row_dot" for w in weights)


def launch_row_dot(reduce, weights: Sequence[torch.Tensor]) -> bool:
    """Whether a launch over ``weights`` takes its row_dot variant.
    ``reduce`` is ``"row_dot"`` (every slot; the default of the wrappers
    and the bit-exact oracle) or per panel one of ``REDUCE_MODES``, the
    choice :func:`panel_reduce` recorded from the data; one ``row_dot``
    panel takes the whole launch, whose buckets share it."""
    if isinstance(reduce, str):
        if reduce != "row_dot":
            raise ValueError(
                f"reduce={reduce!r}: expected 'row_dot' or per panel one of "
                f"{REDUCE_MODES} (panel_reduce)"
            )
        return True
    reduce = tuple(reduce)
    if len(reduce) != len(weights) or any(r not in REDUCE_MODES for r in reduce):
        raise ValueError(
            f"reduce={reduce!r}: expected one of {REDUCE_MODES} for each of "
            f"{len(weights)} panels"
        )
    return "row_dot" in reduce


# -- step-engine selection ------------------------------------------------

# the fused and event kernels' per-bucket argument tables
# (csrc/fused_step.cu, csrc/fused_plastic_step.cu, csrc/event_step.cu:
# kMaxBuckets)
FUSED_MAX_BUCKETS = 32

# Session's activity-adaptive dispatcher (SimConfig(gather="auto")) swaps to
# the event engine below this running mean spike rate (spikes per neuron per
# step) and back to the dense sweep above it.  The reference's value
# (repro/kernels/dispatch.py:EVENT_ACTIVITY_THRESHOLD), kept so both
# packages take the same engine for the same net; the port's own crossover
# is not measured yet.
EVENT_ACTIVITY_THRESHOLD = 0.002


STEP_ENGINES = (
    "fused", "fused_plastic", "fused_event",
    "fused_split", "fused_split_plastic", "fused_split_event",
    "unfused",
)
OVERLAP_MODES = ("off", "local", "double_buffer")


# -- per-engine contracts (checked by repro_torch.analysis.contracts) -------
#
# The counterpart of the reference's ENGINE_CONTRACTS
# (repro/kernels/dispatch.py:255-360): what one step of each engine may do,
# checked on every eligible configuration of the selector's matrix, on the
# CPU (the ops of uncaptured steps) and on the card (the captured graphs).
# The reference's VMEM residency counts have no counterpart: the port's
# kernels keep nothing resident, and the limits they have (LIF-only,
# FUSED_MAX_BUCKETS, the bitmask's shared-memory threshold) are the
# selector's and the kernels' own checks.

# Where a step may make an int64 tensor (a view of one makes none), and why.
# Any other int64 value, and any float64 or complex128 value, is a breach:
# the engines hold f32 state and int32 panels.
INT64_PLACES = {
    "t": "the carry's step t, a 0-d int64 on the device (the reference's "
         "scan carry), made only at T_PLACES: each partition's copy of it for "
         "the run, and its t + 1 once a step",
    "simulator.py:make_core_step.<locals>.step_slots":
        "the step's ring rows t % D and (t + d) % D, made from t on the device: "
        "torch's index ops (index_select, index_copy_, index_add_) take int64 indices",
    "dist_sim.py:compact_spike_ids":
        "the index exchange's prefix sum and its scatter_ indices (torch's "
        "cumsum of a bool and scatter_ are int64), the reference's "
        "jnp.nonzero(size=cap)",
    "dist_sim.py:DistSimulator._exchange":
        "the index exchange's global ids (ids + p * n_p), as int64 index tensors",
    "dist_sim.py:DistSimulator._gather":
        "the index exchange's one exchange, the partitions' int64 ids concatenated",
    "dist_sim.py:_scatter_ones":
        "the index exchange's ids clamped for index_fill_ (an int64 index)",
}
# where the carry's t is made: the run's copy, and each step's t + 1
T_PLACES = ("simulator.py:copy_carry", "simulator.py:make_core_step.<locals>.post")
_RING_ROWS = ("t", "simulator.py:make_core_step.<locals>.step_slots")
_INDEX_EXCHANGE = (
    "dist_sim.py:compact_spike_ids", "dist_sim.py:DistSimulator._exchange",
    "dist_sim.py:DistSimulator._gather", "dist_sim.py:_scatter_ones",
)


@dataclasses.dataclass(frozen=True)
class EngineContract:
    """The checked promises of one step engine.

    ``exchanges_per_step`` maps an exchange key -- ``identity`` / ``dense``
    / ``index``, with ``+plastic`` when the exchange also carries the
    pre-trace vector -- to the EXACT number of exchanges one step makes (an
    exchange is one gather over the partitions, the reference's one
    ``all_gather``; ``DistSimulator._gather``).  A key absent from the map
    is no configuration of the engine, and the checker fails if the
    selector ever produces it.  ``host_syncs_per_step`` is the number of
    reads back to the host a step may make: 0 for every engine, so a chunk
    can be captured as one CUDA graph.  ``int64_places`` are the keys of
    :data:`INT64_PLACES` where a step may make int64 values (the index
    exchange's places count only on its ``index`` keys).  No float64 value
    is ever allowed."""

    engine: str
    exchanges_per_step: Dict[str, int]
    host_syncs_per_step: int = 0
    int64_places: Tuple[str, ...] = _RING_ROWS


ENGINE_CONTRACTS: Dict[str, EngineContract] = {
    c.engine: c
    for c in (
        EngineContract("fused", {"identity": 0}),
        EngineContract("fused_plastic", {"identity+plastic": 0}),
        EngineContract("fused_event", {"identity": 0}),
        EngineContract("fused_split", {"dense": 1, "index": 1},
                       int64_places=_RING_ROWS + _INDEX_EXCHANGE),
        EngineContract(
            "fused_split_plastic",
            # dense carries spikes and traces in ONE exchange; the index
            # exchange needs a second one for the dense real-valued
            # pre-trace vector
            {"dense+plastic": 1, "index+plastic": 2},
            int64_places=_RING_ROWS + _INDEX_EXCHANGE,
        ),
        EngineContract("fused_split_event", {"dense": 1, "index": 1},
                       int64_places=_RING_ROWS + _INDEX_EXCHANGE),
        EngineContract(
            # its exchange discipline is the split engines'
            "unfused",
            {
                "identity": 0, "identity+plastic": 0,
                "dense": 1, "index": 1,
                "dense+plastic": 1, "index+plastic": 2,
            },
            int64_places=_RING_ROWS + _INDEX_EXCHANGE,
        ),
    )
}
if set(ENGINE_CONTRACTS) != set(STEP_ENGINES):
    raise AssertionError(
        "every step engine must declare an EngineContract: missing "
        f"{sorted(set(STEP_ENGINES) - set(ENGINE_CONTRACTS))}"
    )


@dataclasses.dataclass(frozen=True)
class StepEngineChoice:
    engine: str  # one of STEP_ENGINES
    reason: str
    # resolved overlap mode (one of OVERLAP_MODES); "off" for the engines
    # that are not split: there is no exchange to overlap
    overlap: str = "off"

    @property
    def fused(self) -> bool:
        return self.engine != "unfused"

    @property
    def split(self) -> bool:
        """True for the engines split at the exchange (k>1)."""
        return self.engine in ("fused_split", "fused_split_plastic", "fused_split_event")

    @property
    def plastic(self) -> bool:
        """True for the variants that fold the STDP pass into the fused
        step."""
        return self.engine in ("fused_plastic", "fused_split_plastic")

    @property
    def event(self) -> bool:
        return self.engine in ("fused_event", "fused_split_event")


def event_gather_blocker(any_plastic: bool) -> Optional[str]:
    """Why the event-driven gather cannot serve this partition (None when
    it can); the reference's rule (``repro/kernels/dispatch.py:367-389``)
    without its VMEM budget on the id buffer.  An event-ineligible
    partition still takes the dense fused engine."""
    if any_plastic:
        return (
            "plastic nets stay dense for now: the STDP pass must visit "
            "every synapse panel every step to apply trace-decay weight "
            "updates, so skipping untouched panels would skip learning"
        )
    return None


def _fusion_blocker(
    models_present: Sequence[str],
    identity_rows: bool,
    n_delay_buckets: int,
) -> Optional[str]:
    if tuple(models_present) != ("lif",):
        return (
            f"heterogeneous vertex models {tuple(models_present)} "
            "(fused step is LIF-only)"
        )
    if not identity_rows:
        return "heavy-row-split ELL needs the segment-sum re-reduction"
    if n_delay_buckets < 1:
        return "no synapses to propagate"
    if n_delay_buckets > FUSED_MAX_BUCKETS:
        return (
            f"{n_delay_buckets} delay buckets exceed the fused kernels' "
            f"argument table ({FUSED_MAX_BUCKETS})"
        )
    return None


def select_step_engine(
    *,
    backend: str,
    models_present: Sequence[str],
    identity_rows: bool,
    n_delay_buckets: int,
    any_plastic: bool = False,
    identity_exchange: bool = True,
    n_global: Optional[int] = None,
    fused: Optional[bool] = None,
    gather: str = "dense",
    overlap: str = "off",
) -> StepEngineChoice:
    """Pick one of ``STEP_ENGINES`` for a partition's step.

    ``identity_exchange`` is a placement input, as in the reference: the
    identity exchange (k=1 dense) takes the single-launch engines, any other
    exchange (k>1, over ``n_global`` ids) the split ones.  ``any_plastic``
    selects the ``*_plastic`` variant and never blocks fusion.

    ``fused=None`` (auto) fuses whenever the partition is eligible and the
    backend runs the CUDA kernels; on ``ref`` it composes the plain versions
    unfused, as the reference does on its ``ref`` backend.  ``fused=True``
    demands fusion (raises if the partition is ineligible); ``fused=False``
    disables it.  ``gather="event"`` takes the event-driven variant; a
    plastic partition (``event_gather_blocker``) keeps the dense variant with
    the reason attached, unless ``fused=True`` demanded the event engine,
    which raises.  SimConfig's ``gather="auto"`` is resolved by ``Session``
    per chunk and never reaches here.

    ``overlap`` is SimConfig's mode; ``"auto"`` resolves to ``"local"`` on
    ``cuda`` and to ``"off"`` on ``ref`` and for identity exchanges.  An
    explicit mode on an identity exchange has no exchange to overlap: it
    falls back to ``"off"`` with the reason attached, or raises with
    ``fused=True``.  The resolved mode is ``StepEngineChoice.overlap``."""
    if gather not in ("dense", "event"):
        raise ValueError(
            f"select_step_engine(gather={gather!r}): expected 'dense' or "
            "'event' ('auto' is resolved by Session before selection)"
        )
    if overlap not in ("auto",) + OVERLAP_MODES:
        raise ValueError(
            f"select_step_engine(overlap={overlap!r}): expected 'auto' or one "
            f"of {OVERLAP_MODES}"
        )
    if overlap == "auto":
        overlap = "local" if backend == "cuda" and not identity_exchange else "off"
    if fused is False:
        return StepEngineChoice("unfused", "disabled by config")
    blocker = _fusion_blocker(models_present, identity_rows, n_delay_buckets)
    if blocker is not None:
        if fused is True:
            raise ValueError(f"fused step engine requested but: {blocker}")
        return StepEngineChoice("unfused", blocker)
    target = "fused" if identity_exchange else "fused_split"
    placement = (
        "identity exchange" if identity_exchange
        else f"split at the exchange of {n_global} global ids"
    )
    if any_plastic:
        target += "_plastic"
        placement += ", STDP fused into the panel pass"
    if gather == "event":
        eb = event_gather_blocker(any_plastic)
        if eb is None:
            target = "fused_event" if identity_exchange else "fused_split_event"
            placement += ", event-driven gather"
        elif fused is True:
            raise ValueError(f"event-driven gather requested but: {eb}")
        else:
            placement += f" (event gather unavailable: {eb})"
    resolved = "off"
    if overlap != "off":
        if not identity_exchange:
            resolved = overlap
            placement += f", {overlap} exchange/compute overlap"
        elif fused is True:
            raise ValueError(
                f"overlap={overlap!r} requested but: identity exchange has no "
                "collective to overlap"
            )
        else:
            placement += " (overlap unavailable: identity exchange has no collective to overlap)"
    if fused is True:
        return StepEngineChoice(target, f"forced by config ({placement})", resolved)
    if backend == "cuda":
        return StepEngineChoice(target, f"auto: cuda backend ({placement})", resolved)
    return StepEngineChoice(
        "unfused", "auto: 'ref' backend composes the plain torch versions"
    )
