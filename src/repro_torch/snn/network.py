"""Network builders -> dCSR.

Every builder returns a :class:`NetworkDef` (plain numpy edge/vertex arrays +
registry + meta) which :func:`to_dcsr` partitions into a
:class:`repro.core.dcsr.DCSRNetwork`.  Includes the paper's own scalability
workload — the Potjans–Diesmann cortical microcircuit (77K neurons / 0.3B
synapses at full scale) — parameterized by ``scale`` so tests run in
milliseconds and benchmarks extrapolate to the paper's numbers.

A copy of ``repro/snn/network.py`` for the port: the same numpy RNG calls in
the same order, so every builder's arrays are byte-identical to the
reference's.  ``to_dcsr`` also takes a procedural ``RuleSpec``
(:mod:`repro_torch.builder`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ..core import from_edges, DCSRNetwork
from ..core.state import ModelRegistry, ModelSpec, default_registry
from .neurons import registry_with_bias, STATE_LAYOUT

Array = np.ndarray


@dataclasses.dataclass
class NetworkDef:
    n: int
    src: Array
    dst: Array
    edge_state: Array  # (m, >=2): weight, delay(steps), ...
    vtx_model: Array
    vtx_state: Array
    coords: Array
    registry: ModelRegistry
    meta: Dict[str, float]
    edge_model: Optional[Array] = None  # default: all syn_static

    @property
    def m(self) -> int:
        return len(self.src)


def to_dcsr(
    net,
    assignment: Optional[Array] = None,
    k: int = 1,
    uniform: bool = False,
    *,
    chunk_rows: Optional[int] = None,
    path: str = "auto",
    device=None,
) -> DCSRNetwork:
    """Partition a NetworkDef.  ``uniform=True`` pads with isolated dummy
    vertices so every partition has exactly the same size.

    Also accepts a :class:`repro_torch.builder.RuleSpec`: with the default
    block assignment each partition's rows are emitted *directly*
    (procedural chunked construction, bit-identical for any k, chunk size
    and sampling path; the keystream runs on ``device``, the card by
    default); a custom ``assignment`` goes through the eager ``NetworkDef``
    bridge, since non-contiguous partitions need the global relabelling."""
    if not isinstance(net, NetworkDef):
        from ..builder.procedural import (
            DEFAULT_CHUNK_ROWS, build_network, network_def,
        )
        from ..builder.rules import RuleSpec

        if not isinstance(net, RuleSpec):
            raise TypeError(
                f"to_dcsr expects a NetworkDef or RuleSpec, got "
                f"{type(net).__name__}"
            )
        if assignment is None:
            return build_network(
                net, k=k, uniform=uniform,
                chunk_rows=chunk_rows or DEFAULT_CHUNK_ROWS, path=path,
                device=device,
            )
        net = network_def(
            net, chunk_rows=chunk_rows or DEFAULT_CHUNK_ROWS, path=path,
            device=device,
        )
    n, src, dst = net.n, net.src, net.dst
    vtx_model, vtx_state, coords = net.vtx_model, net.vtx_state, net.coords
    if assignment is None:
        from ..core.partition import block_partition

        assignment = block_partition(n, k)
    assignment = np.asarray(assignment, dtype=np.int64)
    k = int(assignment.max()) + 1
    if uniform:
        counts = np.bincount(assignment, minlength=k)
        target = int(counts.max())
        deficit = target - counts
        extra = int(deficit.sum())
        if extra:
            pad_assign = np.repeat(np.arange(k, dtype=np.int64), deficit)
            assignment = np.concatenate([assignment, pad_assign])
            vtx_model = np.concatenate(
                [vtx_model, np.full(extra, vtx_model[0], np.int32)]
            )
            pad_state = np.zeros(
                (extra, vtx_state.shape[1]), dtype=np.float32
            )
            # dummy neurons: clamp far below threshold, huge refractory
            pad_state[:, 0] = -1e6  # v
            pad_state[:, 1] = 1e9  # refrac (lif/alif); harmless for izh
            vtx_state = np.concatenate([vtx_state, pad_state])
            coords = np.concatenate(
                [coords, np.zeros((extra, 3), np.float32)]
            )
            n += extra
    dcsr = from_edges(
        n, src, dst, net.edge_state,
        edge_model=net.edge_model,
        vtx_model=vtx_model, vtx_state=vtx_state, coords=coords,
        registry=net.registry, assignment=assignment,
        meta=net.meta,
    )
    return dcsr


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

def _lif_vertex_state(
    n: int, rng, registry: ModelRegistry, bias_mu: float, bias_sigma: float
) -> Tuple[Array, Array]:
    p = registry.spec("lif").params
    sv = registry.max_vertex_state
    state = np.zeros((n, sv), dtype=np.float32)
    state[:, 0] = rng.uniform(p["v_reset"], p["v_thresh"], n)  # v
    state[:, 2] = rng.normal(bias_mu, bias_sigma, n)  # bias
    model = np.full(n, registry.vertex_id("lif"), dtype=np.int32)
    return model, state


def spatial_random(
    n: int,
    avg_degree: float = 20.0,
    *,
    w_mu: float = 1.2,
    w_sigma: float = 0.3,
    inhibitory_frac: float = 0.2,
    g: float = 4.0,
    delay_max_steps: int = 8,
    bias_mu: float = 14.5,
    bias_sigma: float = 1.0,
    stdp: bool = False,
    seed: int = 0,
) -> NetworkDef:
    """Spatially-embedded random net: uniform coords in the unit cube,
    distance-biased connectivity, distance-proportional integer delays.
    The workhorse for partitioning/serialization tests (geometric structure
    exercises voxel/RCB partitioners meaningfully)."""
    rng = np.random.default_rng(seed)
    registry = registry_with_bias(default_registry())
    coords = rng.random((n, 3)).astype(np.float32)
    m = int(n * avg_degree)
    # distance-biased: propose 3x, keep nearest m
    prop = 3 * m
    src = rng.integers(0, n, prop)
    dst = rng.integers(0, n, prop)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    d2 = np.sum((coords[src] - coords[dst]) ** 2, axis=1)
    order = np.argsort(d2, kind="stable")[:m]
    src, dst, d2 = src[order], dst[order], d2[order]
    m = len(src)
    inh = rng.random(m) < inhibitory_frac
    w = np.abs(rng.normal(w_mu, w_sigma, m)).astype(np.float32)
    w[inh] *= -g
    delay = np.clip(
        np.ceil(np.sqrt(d2) / np.sqrt(3.0) * delay_max_steps), 1,
        delay_max_steps,
    ).astype(np.float32)
    edge_state = np.stack([w, delay], axis=1)
    vtx_model, vtx_state = _lif_vertex_state(
        n, rng, registry, bias_mu, bias_sigma
    )
    emodel = np.full(
        m,
        registry.edge_id("syn_stdp" if stdp else "syn_static"),
        dtype=np.int32,
    )
    return NetworkDef(
        n=n, src=src.astype(np.int64), dst=dst.astype(np.int64),
        edge_state=edge_state, vtx_model=vtx_model, vtx_state=vtx_state,
        coords=coords, registry=registry, edge_model=emodel,
        meta=dict(dt=0.1, noise_sigma=0.5, seed=float(seed)),
    )


# Potjans & Diesmann (2014) cortical microcircuit: populations and the 8x8
# connection-probability table (rows = target, cols = source), full-scale
# sizes summing to 77,169 neurons ("roughly 76K" in the paper) and ~0.3B
# synapses — the paper's serialization scalability example.
PD14_POPS = ("L23E", "L23I", "L4E", "L4I", "L5E", "L5I", "L6E", "L6I")
PD14_SIZES = (20683, 5834, 21915, 5479, 4850, 1065, 14395, 2948)
PD14_PROBS = np.array(
    [
        [0.1009, 0.1689, 0.0437, 0.0818, 0.0323, 0.0000, 0.0076, 0.0000],
        [0.1346, 0.1371, 0.0316, 0.0515, 0.0755, 0.0000, 0.0042, 0.0000],
        [0.0077, 0.0059, 0.0497, 0.1350, 0.0067, 0.0003, 0.0453, 0.0000],
        [0.0691, 0.0029, 0.0794, 0.1597, 0.0033, 0.0000, 0.1057, 0.0000],
        [0.1004, 0.0622, 0.0505, 0.0057, 0.0831, 0.3726, 0.0204, 0.0000],
        [0.0548, 0.0269, 0.0257, 0.0022, 0.0600, 0.3158, 0.0086, 0.0000],
        [0.0156, 0.0066, 0.0211, 0.0166, 0.0572, 0.0197, 0.0396, 0.2252],
        [0.0364, 0.0010, 0.0034, 0.0005, 0.0277, 0.0080, 0.0658, 0.1443],
    ]
)


def microcircuit(scale: float = 1.0, *, seed: int = 0,
                 delay_exc: int = 15, delay_inh: int = 8,
                 w_exc: float = 0.15, g: float = 4.0) -> NetworkDef:
    """Scaled Potjans–Diesmann microcircuit.

    Neuron counts scale by ``scale``; synapse counts by ``scale**2`` via the
    fixed-total-number rule K_ts = p_ts * N_s * N_t (multapses allowed, as in
    NEST).  Delays in 0.1 ms steps (1.5 ms exc / 0.8 ms inh).
    """
    rng = np.random.default_rng(seed)
    registry = registry_with_bias(default_registry())
    sizes = np.maximum((np.asarray(PD14_SIZES) * scale).astype(np.int64), 2)
    n = int(sizes.sum())
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    srcs, dsts, ws, ds = [], [], [], []
    for ti in range(8):
        for si in range(8):
            p = PD14_PROBS[ti, si]
            if p == 0.0:
                continue
            k_ts = int(round(p * sizes[si] * sizes[ti]))
            if k_ts == 0:
                continue
            s = rng.integers(offsets[si], offsets[si + 1], k_ts)
            t = rng.integers(offsets[ti], offsets[ti + 1], k_ts)
            exc = si % 2 == 0
            w = rng.normal(
                w_exc if exc else -g * w_exc,
                0.1 * w_exc, k_ts,
            ).astype(np.float32)
            w = np.abs(w) if exc else -np.abs(w)
            delay = np.full(k_ts, delay_exc if exc else delay_inh,
                            dtype=np.float32)
            srcs.append(s)
            dsts.append(t)
            ws.append(w)
            ds.append(delay)
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    edge_state = np.stack(
        [np.concatenate(ws), np.concatenate(ds)], axis=1
    )
    # Layered coordinates: each population a slab in z, uniform in x/y.
    coords = rng.random((n, 3)).astype(np.float32)
    for pi in range(8):
        coords[offsets[pi] : offsets[pi + 1], 2] = (
            pi + coords[offsets[pi] : offsets[pi + 1], 2]
        ) / 8.0
    vtx_model, vtx_state = _lif_vertex_state(n, rng, registry, 15.2, 0.4)
    return NetworkDef(
        n=n, src=src.astype(np.int64), dst=dst.astype(np.int64),
        edge_state=edge_state, vtx_model=vtx_model, vtx_state=vtx_state,
        coords=coords, registry=registry,
        meta=dict(dt=0.1, noise_sigma=1.0, seed=float(seed),
                  scale=float(scale)),
    )


def mixed_population(
    n: int = 300,
    *,
    fractions=(("lif", 0.5), ("alif", 0.3), ("izhikevich", 0.2)),
    avg_degree: float = 12.0,
    w_mu: float = 0.8,
    seed: int = 0,
) -> NetworkDef:
    """Heterogeneous network mixing neuron models in one partition space —
    the paper's model dictionary under load: per-vertex tuples of
    *different* sizes, serialized/simulated side by side."""
    rng = np.random.default_rng(seed)
    registry = registry_with_bias(default_registry())
    coords = rng.random((n, 3)).astype(np.float32)
    # assign models by fraction
    vtx_model = np.zeros(n, np.int32)
    vtx_state = np.zeros((n, registry.max_vertex_state), np.float32)
    bounds = np.cumsum([0] + [f for _, f in fractions])
    cuts = (bounds * n).astype(int)
    cuts[-1] = n
    order = rng.permutation(n)
    from .neurons import LIF_BIAS, ALIF_BIAS, IZH_BIAS

    for (name, _), a, b in zip(fractions, cuts[:-1], cuts[1:]):
        idx = order[a:b]
        mid = registry.vertex_id(name)
        vtx_model[idx] = mid
        if name in ("lif", "alif"):
            p = registry.spec(name).params
            vtx_state[idx, 0] = rng.uniform(
                p["v_reset"], p["v_thresh"], len(idx)
            )
            col = LIF_BIAS if name == "lif" else ALIF_BIAS
            vtx_state[idx, col] = rng.normal(14.6, 0.8, len(idx))
        else:  # izhikevich
            vtx_state[idx, 0] = -65.0
            vtx_state[idx, 1] = -13.0  # u = b*v
            vtx_state[idx, IZH_BIAS] = rng.normal(6.0, 2.0, len(idx))
    m = int(n * avg_degree)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    w = np.abs(rng.normal(w_mu, 0.2, m)).astype(np.float32)
    w[rng.random(m) < 0.2] *= -4.0
    delay = rng.integers(1, 6, m).astype(np.float32)
    return NetworkDef(
        n=n, src=src.astype(np.int64), dst=dst.astype(np.int64),
        edge_state=np.stack([w, delay], 1),
        vtx_model=vtx_model, vtx_state=vtx_state, coords=coords,
        registry=registry,
        meta=dict(dt=0.1, noise_sigma=0.6, seed=float(seed)),
    )


def balanced_ei(
    n: int = 1000,
    *,
    epsilon: float = 0.1,
    g: float = 5.0,
    w: float = 0.5,
    delay_steps: int = 15,
    stdp: bool = True,
    seed: int = 0,
) -> NetworkDef:
    """Brunel-style balanced excitatory/inhibitory random network (80/20)
    with STDP on E->E synapses — the plasticity + event-serialization
    test workload."""
    rng = np.random.default_rng(seed)
    registry = registry_with_bias(default_registry())
    n_e = int(0.8 * n)
    c_e = max(int(epsilon * n_e), 1)
    c_i = max(int(epsilon * (n - n_e)), 1)
    src_list, dst_list = [], []
    for tgt in range(n):
        se = rng.choice(n_e, c_e, replace=False)
        si = n_e + rng.choice(n - n_e, c_i, replace=False)
        src_list.append(np.concatenate([se, si]))
        dst_list.append(np.full(c_e + c_i, tgt, dtype=np.int64))
    src = np.concatenate(src_list)
    dst = np.concatenate(dst_list)
    m = len(src)
    weights = np.where(src < n_e, w, -g * w).astype(np.float32)
    delays = rng.integers(1, delay_steps + 1, m).astype(np.float32)
    edge_state = np.stack([weights, delays], axis=1)
    emodel = np.where(
        (src < n_e) & (dst < n_e) & stdp,
        registry.edge_id("syn_stdp"),
        registry.edge_id("syn_static"),
    ).astype(np.int32)
    vtx_model, vtx_state = _lif_vertex_state(n, rng, registry, 14.8, 0.6)
    coords = rng.random((n, 3)).astype(np.float32)
    net = NetworkDef(
        n=n, src=src, dst=dst, edge_state=edge_state,
        vtx_model=vtx_model, vtx_state=vtx_state, coords=coords,
        registry=registry, edge_model=emodel,
        meta=dict(dt=0.1, noise_sigma=0.8, seed=float(seed)),
    )
    return net
