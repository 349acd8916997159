"""Engine-contract checker: every step engine's declared contract
(``kernels/dispatch.py:ENGINE_CONTRACTS``) checked on every eligible
configuration of the selector's matrix (engine x exchange x overlap x
gather x k, and the heavy-row split).

Counterpart of ``repro/analysis/contracts.py``.  The reference checks its
contracts on the lowered program (jaxpr and HLO); the port has none, so it
checks what its steps do, in two views of each matrix row, built on the
reference's tiny net (``balanced_ei(160, seed=7, delay_steps=5)``, k up to
2, the partitions on ``devices=[device] * k``):

* the **ops view** (on the CPU, and on the card with ``--device cuda``): a
  ``TorchDispatchMode`` over a few uncaptured steps sees every aten op the
  engine issues around its kernels.  A kernel call (a registered op of
  ``kernels/dispatch.py``, the CUDA kernel or its plain version) is opaque:
  only its outputs are seen, since on the card it is one launch.  The view
  counts host syncs (``aten._local_scalar_dense``, ``aten.nonzero``,
  ``aten.is_nonzero``, ``aten.equal``), float64 and complex128 values,
  int64 values made outside the contract's places (a view of one makes
  none), the widest 1-D f32 value, and the exchanges a step
  (``DistSimulator._gather``, one per exchange);
* the **graph view** (``--device cuda``): each row's chunk captured through
  ``simulator.ChunkGraphs``, its kernel nodes a step and its memcpy nodes
  to the host (which must be none) read from the graph with libcuda
  (:func:`graph_node_kinds`), and one uncaptured chunk run under
  ``torch.cuda.set_sync_debug_mode("error")``.

Run as ``python -m repro_torch.analysis.contracts [--device cpu|cuda]``:
one line per row, exit 0 only if every row honours its contract.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import os
import sys
import time
from collections import Counter
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels import dispatch

# aten ops that read a value back to the host: forbidden in a step
HOST_SYNC_OPS = frozenset({
    "aten::_local_scalar_dense", "aten::nonzero", "aten::is_nonzero", "aten::equal",
})
# dtypes no engine may make (f32 state, int32 panels)
WIDE_FLOATS = (torch.float64, torch.complex128)
_PORT = f"{os.sep}repro_torch{os.sep}"
_HERE = os.path.abspath(__file__)


def _where(frame) -> str:
    """``file:qualname`` of the innermost function of the port above the
    checker (a comprehension or lambda counts as its function), the place
    a value is made (``dispatch.INT64_PLACES`` keys)."""
    while frame is not None:
        name = frame.f_code.co_filename
        if (_PORT in name and os.path.abspath(name) != _HERE
                and not frame.f_code.co_name.startswith("<")):
            return f"{os.path.basename(name)}:{frame.f_code.co_qualname}"
        frame = frame.f_back
    return "outside the port"


@dataclasses.dataclass
class StepFacts:
    """What the ops view saw over ``steps`` uncaptured steps."""

    steps: int = 0
    partitions: int = 1  # k: each makes its own carry t
    exchanges: int = 0  # DistSimulator._gather calls
    host_syncs: List[str] = dataclasses.field(default_factory=list)  # "op at place"
    wide_values: List[Tuple[str, str]] = dataclasses.field(default_factory=list)  # (place, dtype)
    int64_values: Dict[str, int] = dataclasses.field(default_factory=dict)  # place -> count
    max_f32_vector: int = 0  # widest 1-D f32 value, kernels' outputs included
    ops: int = 0  # aten ops seen outside the kernels


class ContractMode(TorchDispatchMode):
    """Records the :class:`StepFacts` of the ops it sees; ops inside an
    opaque kernel call (:func:`opaque_kernels`) are skipped, and the call's
    outputs are noted as the kernel's."""

    def __init__(self, facts: StepFacts):
        super().__init__()
        self.facts = facts
        self.kernel_depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.kernel_depth:
            return out
        name = func._schema.name
        self.facts.ops += 1
        if name in HOST_SYNC_OPS:
            self.facts.host_syncs.append(f"{name} at {_where(sys._getframe(1))}")
        self.note(out, lambda: _where(sys._getframe(2)), view=func.is_view)
        return out

    def note(self, out, place: Callable[[], str], view: bool = False) -> None:
        """Note the tensors of ``out``; ``view``: they are views (of a value
        already noted where it was made)."""
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            if t.dtype in WIDE_FLOATS:
                entry = (place(), str(t.dtype).replace("torch.", ""))
                if entry not in self.facts.wide_values:
                    self.facts.wide_values.append(entry)
            elif t.dtype == torch.int64 and not view:
                where = place()
                # the carry's t is a 0-d int64 made only where the run
                # copies it and where each step adds 1
                key = "t" if t.dim() == 0 and where in dispatch.T_PLACES else where
                self.facts.int64_values[key] = self.facts.int64_values.get(key, 0) + 1
            elif t.dtype == torch.float32 and t.dim() == 1:
                self.facts.max_f32_vector = max(self.facts.max_f32_vector, t.shape[0])


@contextlib.contextmanager
def opaque_kernels(mode: ContractMode):
    """Every registered kernel op (``dispatch._REGISTRY``, both backends)
    runs as one opaque call while the block runs: the mode skips its inner
    ops and notes its outputs, as the card runs it as one launch."""
    saved = dict(dispatch._REGISTRY)

    def wrap(op, fn):
        def call(*args, **kwargs):
            mode.kernel_depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                mode.kernel_depth -= 1
            if not mode.kernel_depth:
                mode.note(out, lambda: f"kernel {op}")
            return out
        return call

    dispatch.lookup("spike_gather", "ref")  # the registry is filled on import of ops
    for (op, backend), fn in list(dispatch._REGISTRY.items()):
        dispatch._REGISTRY[(op, backend)] = wrap(op, fn)
    try:
        yield
    finally:
        dispatch._REGISTRY.clear()
        dispatch._REGISTRY.update(saved)


@contextlib.contextmanager
def counting_exchanges(sim, facts: StepFacts):
    """Count ``DistSimulator._gather`` calls (one per exchange) into
    ``facts.exchanges`` while the block runs; a k = 1 simulator has none."""
    own = getattr(sim, "_gather", None)
    if own is None:
        yield
        return

    def gather(*fields):
        facts.exchanges += 1
        return own(*fields)

    sim._gather = gather
    try:
        yield
    finally:
        del sim._gather


@contextlib.contextmanager
def uncaptured(sim):
    """Runs of ``sim`` on the uncaptured loop (the ``_graphs=False`` seam)."""
    own = sim._graphs_on
    sim._graphs_on = False
    try:
        yield
    finally:
        sim._graphs_on = own


def step_facts(sim, steps: int, state=None) -> StepFacts:
    """The ops view of ``steps`` uncaptured steps of ``sim`` (a
    ``Simulator`` or ``DistSimulator``) from ``state`` (its initial state
    when None)."""
    state = sim.init_state() if state is None else state
    facts = StepFacts(steps=steps, partitions=len(getattr(sim, "devs", [sim])))
    mode = ContractMode(facts)
    with uncaptured(sim), opaque_kernels(mode), counting_exchanges(sim, facts), mode:
        sim.run(state, steps, record_raster=False, record_v=False)
    return facts


# ---------------------------------------------------------------------------
# Contract verdicts
# ---------------------------------------------------------------------------


def exchange_key(exchange: str, plastic: bool) -> str:
    """The ``exchanges_per_step`` key of a configuration: the exchange
    flavour, ``+plastic`` when the exchange also carries the pre-trace
    vector."""
    return exchange + ("+plastic" if plastic else "")


def check_step_facts(facts: StepFacts, contract, key: str, *, n_global: int,
                     rows: int) -> List[str]:
    """Contract breaches in the ops view of ``facts.steps`` steps (empty:
    clean).  ``rows`` is the most rows of a panel: a 1-D f32 value may be
    as wide as the exchanged activity (``n_global``, plus the one bin of
    the index exchange's scatter that collects the ids past its cap) or a
    panel's rows (a gather's currents, ``stdp_update``'s per-row terms),
    never wider: an O(n^2) or O(R * K) vector would be."""
    eng = f"engine {contract.engine!r} [{key}]"
    expected = contract.exchanges_per_step.get(key)
    if expected is None:
        return [f"exchange {key!r} is not a declared configuration of engine "
                f"{contract.engine!r} (contract keys: {sorted(contract.exchanges_per_step)})"]
    problems: List[str] = []
    steps = max(facts.steps, 1)
    if facts.exchanges != expected * facts.steps:
        problems.append(f"{eng}: {facts.exchanges} exchange(s) over {facts.steps} steps, "
                        f"contract says exactly {expected} a step")
    if len(facts.host_syncs) > contract.host_syncs_per_step * facts.steps:
        problems.append(f"{eng}: {len(facts.host_syncs) / steps:g} host sync(s) a step "
                        f"({sorted(set(facts.host_syncs))}), contract allows "
                        f"{contract.host_syncs_per_step}")
    for where, dtype in facts.wide_values:
        problems.append(f"{eng}: {dtype} value at {where}: an 8-byte float (engines are "
                        "f32/int32)")
    allowed = {p for p in contract.int64_places
               if key.startswith("index") or p not in dispatch._INDEX_EXCHANGE}
    t_made = facts.int64_values.get("t", 0)
    if t_made > facts.partitions * (facts.steps + 1):
        problems.append(f"{eng}: {t_made} 0-d int64 value(s) made at the carry's t places "
                        f"{list(dispatch.T_PLACES)}, more than each partition's copy of t "
                        "and one t + 1 a step")
    for where, n in sorted(facts.int64_values.items()):
        if where not in allowed:
            problems.append(f"{eng}: {n} int64 value(s) made at {where}, not one of the "
                            f"contract's int64 places {sorted(allowed)}")
    bound = max(n_global + 1, rows)
    if facts.max_f32_vector > bound:
        problems.append(f"{eng}: a 1-D f32 value of width {facts.max_f32_vector}, wider than "
                        f"the exchanged activity ({n_global}, and the index exchange's one "
                        f"bin) and a panel's rows ({rows})")
    return problems


# ---------------------------------------------------------------------------
# The graph view (on the card)
# ---------------------------------------------------------------------------

# CUgraphNodeType (cuda.h): the node kinds a captured chunk holds
GRAPH_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}
_CU_MEMORYTYPE_HOST, _CU_MEMORYTYPE_UNIFIED = 1, 4
_CU_POINTER_ATTRIBUTE_MEMORY_TYPE = 2


class _Memcpy3D(ctypes.Structure):
    """``CUDA_MEMCPY3D`` (cuda.h), a memcpy node's parameters."""

    _fields_ = [
        ("srcXInBytes", ctypes.c_size_t), ("srcY", ctypes.c_size_t),
        ("srcZ", ctypes.c_size_t), ("srcLOD", ctypes.c_size_t),
        ("srcMemoryType", ctypes.c_int), ("srcHost", ctypes.c_void_p),
        ("srcDevice", ctypes.c_uint64), ("srcArray", ctypes.c_void_p),
        ("reserved0", ctypes.c_void_p), ("srcPitch", ctypes.c_size_t),
        ("srcHeight", ctypes.c_size_t),
        ("dstXInBytes", ctypes.c_size_t), ("dstY", ctypes.c_size_t),
        ("dstZ", ctypes.c_size_t), ("dstLOD", ctypes.c_size_t),
        ("dstMemoryType", ctypes.c_int), ("dstHost", ctypes.c_void_p),
        ("dstDevice", ctypes.c_uint64), ("dstArray", ctypes.c_void_p),
        ("reserved1", ctypes.c_void_p), ("dstPitch", ctypes.c_size_t),
        ("dstHeight", ctypes.c_size_t),
        ("WidthInBytes", ctypes.c_size_t), ("Height", ctypes.c_size_t),
        ("Depth", ctypes.c_size_t),
    ]


def _libcuda():
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.cuGraphMemcpyNodeGetParams.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Memcpy3D)]
    lib.cuPointerGetAttribute.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64]
    return lib


def _to_host(lib, params: _Memcpy3D) -> bool:
    """Whether a memcpy node writes host memory: a host destination, or a
    unified address that libcuda does not place on a device."""
    if params.dstMemoryType == _CU_MEMORYTYPE_HOST:
        return True
    if params.dstMemoryType != _CU_MEMORYTYPE_UNIFIED:
        return False
    kind = ctypes.c_int(0)
    rc = lib.cuPointerGetAttribute(ctypes.byref(kind), _CU_POINTER_ATTRIBUTE_MEMORY_TYPE,
                                   params.dstDevice)
    return rc != 0 or kind.value == _CU_MEMORYTYPE_HOST


def graph_node_kinds(graph) -> Counter:
    """The nodes of a captured ``torch.cuda.CUDAGraph`` (made with
    ``keep_graph=True``) by kind (``kernel``, ``memcpy``, ``memset``,
    ``other``), and under ``memcpy_to_host`` the memcpy nodes that write
    host memory; read with libcuda's ``cuGraphGetNodes``,
    ``cuGraphNodeGetType`` and ``cuGraphMemcpyNodeGetParams`` on
    ``raw_cuda_graph()`` (a ``cudaGraph_t`` is a ``CUgraph``)."""
    lib = _libcuda()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if lib.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if lib.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = Counter(memcpy_to_host=0)
    for node in nodes:
        kind = ctypes.c_int(-1)
        if lib.cuGraphNodeGetType(node, ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        label = GRAPH_NODE_KINDS.get(kind.value, "other")
        kinds[label] += 1
        if label == "memcpy":
            params = _Memcpy3D()
            if lib.cuGraphMemcpyNodeGetParams(node, ctypes.byref(params)) != 0:
                raise RuntimeError("cuGraphMemcpyNodeGetParams failed")
            kinds["memcpy_to_host"] += int(_to_host(lib, params))
    return kinds


def graph_view(sim, steps: int) -> Tuple[List[str], Dict[str, float]]:
    """``(problems, kernel nodes a step per captured key)`` of ``sim`` on
    the card: a graphed run of ``steps`` steps (which captures its key),
    the captured graphs' nodes, and one uncaptured chunk of ``steps``
    steps under ``torch.cuda.set_sync_debug_mode("error")``."""
    problems: List[str] = []
    if sim.graph_mode != "cuda_graph":
        return [f"the chunk is not captured: {sim.graph_mode}"], {}
    state = sim.init_state()
    sim.run(state, steps)
    per_step = {}
    for g in sim._graphs.graphs.values():
        kinds = graph_node_kinds(g.graph)
        per_step[g.what] = kinds["kernel"] / g.steps
        if kinds["memcpy_to_host"]:
            problems.append(f"{g.what}: {kinds['memcpy_to_host']} memcpy node(s) to the host "
                            "in the captured chunk")
    with uncaptured(sim):
        sim.run(state, 1)  # the library and every module loaded first
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            sim.run(state, steps)
        except RuntimeError as err:
            problems.append(f"a host sync in an uncaptured chunk: {err}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    return problems, per_step


# ---------------------------------------------------------------------------
# The selector matrix
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CaseSpec:
    """One eligible configuration of the selector matrix."""

    name: str
    k: int
    engine: str  # expected selected engine
    exchange: str  # 'identity' | 'dense' | 'index'
    plastic: bool = False
    gather: str = "dense"
    overlap: str = "off"
    max_k: Optional[int] = None  # the heavy-row split (k = 1 only)

    @property
    def key(self) -> str:
        return exchange_key(self.exchange, self.plastic)


# rows wider than this split on the matrix's net (about 3 synapses a row
# and bucket, at most 8)
MAXK_SPLIT = 2


def contract_matrix() -> List[CaseSpec]:
    """The reference's matrix (``repro/analysis/contracts.py:308-343``),
    k capped at 2, and the heavy-row split's two rows."""
    specs: List[CaseSpec] = [
        CaseSpec("k1_fused", 1, "fused", "identity"),
        CaseSpec("k1_fused_plastic", 1, "fused_plastic", "identity", plastic=True),
        CaseSpec("k1_fused_event", 1, "fused_event", "identity", gather="event"),
        CaseSpec("k1_unfused", 1, "unfused", "identity"),
        CaseSpec("k1_unfused_plastic", 1, "unfused", "identity", plastic=True),
        CaseSpec("k1_unfused_maxk", 1, "unfused", "identity", max_k=MAXK_SPLIT),
        CaseSpec("k1_unfused_plastic_maxk", 1, "unfused", "identity", plastic=True,
                 max_k=MAXK_SPLIT),
    ]
    for ex in ("dense", "index"):
        for ov in ("off", "local", "double_buffer"):
            specs.append(CaseSpec(f"k2_split_{ex}_{ov}", 2, "fused_split", ex, overlap=ov))
            specs.append(CaseSpec(f"k2_split_plastic_{ex}_{ov}", 2, "fused_split_plastic",
                                  ex, plastic=True, overlap=ov))
        for ov in ("off", "local"):
            specs.append(CaseSpec(f"k2_split_event_{ex}_{ov}", 2, "fused_split_event", ex,
                                  gather="event", overlap=ov))
    specs.append(CaseSpec("k2_unfused_dense", 2, "unfused", "dense"))
    specs.append(CaseSpec("k2_unfused_index_plastic", 2, "unfused", "index", plastic=True))
    return specs


_NET_N = 160  # tiny fixed topology: contracts are structural, not scale


def build_sim(spec: CaseSpec, device=None):
    """``(sim, n_global, rows)`` of a matrix row on ``device`` (the card
    unless given another; the k partitions on ``[device] * k``): the
    engine the row names, forced as the reference forces it, no
    recordings; ``rows`` is the most rows of a panel."""
    from ..core.partition import block_partition
    from ..snn.dist_sim import DistSimulator
    from ..snn.network import balanced_ei, to_dcsr
    from ..snn.simulator import SimConfig, Simulator

    device = dispatch.resolve_device(device)
    net = balanced_ei(_NET_N, stdp=spec.plastic, seed=7, delay_steps=5)
    d = to_dcsr(net, assignment=block_partition(_NET_N, spec.k), uniform=True)
    cfg = SimConfig(
        fused=spec.engine != "unfused",
        exchange="dense" if spec.exchange == "identity" else spec.exchange,
        gather=spec.gather, overlap=spec.overlap, max_k=spec.max_k,
        record_raster=False, record_v=False,
    )
    if spec.k == 1:
        sim = Simulator(d, cfg, device=device)
        devs = [sim.dev]
    else:
        sim = DistSimulator(d, cfg, devices=[device] * spec.k)
        devs = sim.devs
    rows = max(c.shape[0] for dev in devs for c in dev.cols)
    return sim, _NET_N, rows


@dataclasses.dataclass
class CaseResult:
    """One matrix row's verdict: its breaches (empty: clean), the engine
    it ran, the ops view's facts, and on the card the kernel nodes a step
    of each captured key."""

    problems: List[str]
    engine: str = ""
    facts: Optional[StepFacts] = None
    kernels_per_step: Dict[str, float] = dataclasses.field(default_factory=dict)


def run_case(spec: CaseSpec, steps: int = 4, device=None) -> CaseResult:
    """Every contract breach of one matrix row on ``device`` (the card
    unless given another): the ops view, and on a CUDA device the graph
    view too."""
    device = dispatch.resolve_device(device)
    sim, n_global, rows = build_sim(spec, device)
    choice = sim.engine_choice
    result = CaseResult([], choice.engine)
    if choice.engine != spec.engine:
        result.problems.append(f"selector picked {choice.engine!r} ({choice.reason}), matrix "
                               f"row expects {spec.engine!r}")
        return result
    if choice.overlap != spec.overlap:
        result.problems.append(f"selector resolved overlap={choice.overlap!r}, matrix row "
                               f"expects {spec.overlap!r}")
    if spec.max_k is not None and all(sim.dev.identity_rows):
        result.problems.append(f"max_k={spec.max_k} split no row: the row checks nothing")
    contract = dispatch.ENGINE_CONTRACTS[choice.engine]
    with uncaptured(sim):  # the first step's one-time work (the library, caches)
        sim.run(sim.init_state(), 1)
    result.facts = step_facts(sim, steps)
    result.problems += check_step_facts(result.facts, contract, spec.key, n_global=n_global,
                                        rows=rows)
    if device.type == "cuda":
        problems, result.kernels_per_step = graph_view(sim, steps)
        result.problems += problems
    return result


def run_matrix(
    specs: Optional[List[CaseSpec]] = None,
    steps: int = 4,
    device=None,
    verbose: bool = True,
) -> Tuple[List[Tuple[str, str]], Dict[str, CaseResult]]:
    """``((row name, breach) pairs, per row its result)`` on ``device``
    (the card unless given another).  An engine that no row of the matrix
    covers is itself a breach."""
    device = dispatch.resolve_device(device)
    specs = contract_matrix() if specs is None else specs
    uncovered = set(dispatch.STEP_ENGINES) - {s.engine for s in contract_matrix()}
    violations: List[Tuple[str, str]] = [
        ("matrix", f"engine {e!r} has no contract_matrix row") for e in sorted(uncovered)
    ]
    results: Dict[str, CaseResult] = {}
    for spec in specs:
        t0 = time.perf_counter()
        try:
            res = run_case(spec, steps=steps, device=device)
        except Exception as e:  # a row that fails to run IS a breach
            res = CaseResult([f"failed to run: {type(e).__name__}: {e}"])
        results[spec.name] = res
        violations += [(spec.name, p) for p in res.problems]
        if verbose:
            nodes = "".join(f"; {what}: {k:.2f} kernels a step"
                            for what, k in res.kernels_per_step.items())
            print(f"  {spec.name:<36} {'FAIL' if res.problems else 'ok':<4}  {res.engine:<20} "
                  f"({time.perf_counter() - t0:.1f} s{nodes})", flush=True)
    return violations, results


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.contracts",
        description="Check every step engine's declared contract on every eligible "
                    "configuration of the selector.",
    )
    ap.add_argument("--device", default=None,
                    help="cuda (the ops and the graph views; the default) or cpu (the "
                         "ops view)")
    ap.add_argument("--steps", type=int, default=4, help="steps a view runs (default 4)")
    ap.add_argument("--only", default="", help="run only rows whose name contains this")
    ap.add_argument("--list", action="store_true", help="print the matrix rows and exit")
    args = ap.parse_args(argv)
    specs = [s for s in contract_matrix() if args.only in s.name]
    if args.list:
        for s in specs:
            print(f"{s.name}: k={s.k} engine={s.engine} key={s.key} gather={s.gather} "
                  f"overlap={s.overlap} max_k={s.max_k}")
        return 0
    device = dispatch.resolve_device(args.device)
    print(f"engine-contract matrix: {len(specs)} row(s), steps={args.steps}, device={device}")
    t0 = time.perf_counter()
    violations, _ = run_matrix(specs, steps=args.steps, device=device)
    wall = time.perf_counter() - t0
    if violations:
        print(f"\n{len(violations)} contract violation(s):")
        for case, problem in violations:
            print(f"  {case}: {problem}")
        return 1
    print(f"OK: {len(specs)} configuration(s) honour their engine contracts ({wall:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
