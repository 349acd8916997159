"""Procedural per-partition dCSR construction.

A port of ``repro/builder/procedural.py``.  Emits each partition's dCSR rows
*directly* from a :class:`RuleSpec` -- row-block at a time, two passes
(degree pass -> exact-fit allocation -> fill pass) -- so no whole-network
``NetworkDef`` ever exists on the host.  Every draw is counter-based
(:mod:`repro_torch.builder.crng`), keyed on ``(seed, stream, global row,
draw index)``, so the result is bit-identical for any partition count, any
chunk size, and either sampling path:

- ``path="ref"``     numpy oracle (the keystream on the host).
- ``path="device"``  keystream words from ``ops.builder_keystream`` on the
                     build's device: the CUDA kernel on the card, its plain
                     torch version on the CPU (``device="cpu"``).  All
                     floating-point assembly still happens host-side in the
                     same numpy code, so words -> network is one shared path.
- ``path="auto"``    "device" on ``resolve_device(device)``: the card, or a
                     raise when there is none and the caller named no device.

Each build records where its host time went (:class:`BuildReport`, on the
network as ``net.build_report``).

The eager bridge :func:`network_def` materializes the same network as a
legacy ``NetworkDef``; ``to_dcsr(network_def(spec), k=k)`` is bit-equal
to :func:`build_network`'s direct emission because chunks are emitted in
row-major order with within-row edges source-sorted -- exactly the order
``from_edges``'s stable ``lexsort((nsrc, ndst))`` produces under the
identity relabelling of a block partition.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.dcsr import DCSRNetwork, DCSRPartition
from ..kernels.dispatch import resolve_device
from . import crng
from .rules import ConnectRule, RuleSpec

DEFAULT_CHUNK_ROWS = 8192

# to_dcsr's dummy-vertex padding constants (uniform partitions for SPMD).
_PAD_V = -1e6
_PAD_REFRAC = 1e9


def _default_registry():
    from ..core.state import default_registry
    from ..snn.neurons import registry_with_bias

    return registry_with_bias(default_registry())


def resolve_build_path(path: str = "auto", device=None) -> Tuple[str, Optional[torch.device]]:
    """``(path, device)`` of a build: ``("ref", None)`` for the numpy
    oracle, else ``("device", resolve_device(device))``, which raises when
    there is no card and the caller named no device."""
    if path not in ("auto", "ref", "device"):
        raise ValueError(f"unknown build path {path!r}")
    if path == "ref":
        return "ref", None
    return "device", resolve_device(device)


@dataclasses.dataclass
class BuildReport:
    """Where a build's host time went.  ``keystream_seconds`` covers the
    word draws: the numpy cipher on ``path="ref"``, and on the device path
    the counters' upload, the launch and the copy of the words back."""

    path: str
    device: Optional[str]
    keystream_calls: int = 0  # draws of at least one word (device: launches)
    keystream_words: int = 0
    keystream_seconds: float = 0.0
    d2h_bytes: int = 0  # words copied back from the device
    seconds: float = 0.0  # the whole build

    @property
    def assembly_seconds(self) -> float:
        """Host time outside the keystream: numpy float assembly, sorting
        and the partition arrays."""
        return self.seconds - self.keystream_seconds


class _Words:
    """Keystream word source: the only place ref and device paths differ."""

    def __init__(self, seed: int, path: str, device: Optional[torch.device],
                 report: BuildReport):
        self.seed = int(seed)
        self.path = path
        self.device = device
        self.report = report

    def __call__(self, stream, rows, j0, n_words):
        rows = np.asarray(rows)
        if rows.size == 0 or n_words == 0:
            return np.zeros((rows.size, n_words), np.uint32)
        t0 = time.perf_counter()
        if self.path == "ref":
            w = crng.word_matrix(self.seed, stream, rows, j0, n_words)
        else:
            from ..kernels import ops
            from ..kernels.keystream import as_uint32

            counters = torch.from_numpy(rows.astype(np.int64, copy=False).ravel())
            w = as_uint32(ops.builder_keystream(
                self.seed, int(stream), counters.to(self.device), int(j0), int(n_words),
            ))
            if self.device.type == "cuda":
                self.report.d2h_bytes += w.nbytes
        self.report.keystream_calls += 1
        self.report.keystream_words += w.size
        self.report.keystream_seconds += time.perf_counter() - t0
        return w


# ---------------------------------------------------------------------------
# Vertex state
# ---------------------------------------------------------------------------


def _coords_for_ids(spec: RuleSpec, words: _Words, ids: np.ndarray) -> np.ndarray:
    """Unit-cube coordinates of arbitrary global vertex ids (float32)."""
    ids = np.asarray(ids, np.int64)
    out = np.empty((len(ids), 3), np.float32)
    for pop, (a, b) in zip(spec.populations, spec.offsets().values()):
        mask = (ids >= a) & (ids < b)
        if not mask.any():
            continue
        cw = words(crng.STREAM_COORD, ids[mask], 0, 4)
        c = crng.uniform01(cw[:, :3])
        if pop.slab is not None:
            i, t = pop.slab
            c[:, 2] = (np.float32(i) + c[:, 2]) / np.float32(t)
        out[mask] = c
    return out


def _vertex_block(spec, words, registry, r0, r1):
    """(vtx_model, vtx_state, coords) for global rows [r0, r1)."""
    R = r1 - r0
    lif = registry.spec("lif").params
    v_lo = np.float32(lif["v_reset"])
    v_span = np.float32(lif["v_thresh"] - lif["v_reset"])
    vmodel = np.full(R, registry.vertex_id("lif"), np.int32)
    vstate = np.zeros((R, registry.max_vertex_state), np.float32)
    rows = np.arange(r0, r1, dtype=np.int64)
    coords = _coords_for_ids(spec, words, rows)
    for pop, (a, b) in zip(spec.populations, spec.offsets().values()):
        lo, hi = max(a, r0), min(b, r1)
        if lo >= hi:
            continue
        sl = slice(lo - r0, hi - r0)
        prows = np.arange(lo, hi, dtype=np.int64)
        if pop.v_uniform:
            u = crng.uniform01(words(crng.STREAM_V, prows, 0, 1)[:, 0])
            vstate[sl, 0] = v_lo + u * v_span
        else:
            vstate[sl, 0] = np.float32(pop.v_init)
        z = crng.standard_normal(words(crng.STREAM_BIAS, prows, 0, crng.NORMAL_WORDS))
        vstate[sl, 2] = np.float32(pop.bias_mu) + np.float32(pop.bias_sigma) * z
    return vmodel, vstate, coords


# ---------------------------------------------------------------------------
# Connectivity
# ---------------------------------------------------------------------------


def _rule_chunk(spec, words, ri: int, rule: ConnectRule, r0: int, r1: int,
                registry, fill: bool):
    """Sample rule ``ri``'s in-edges for target rows [r0, r1).

    Returns ``(deg, payload)`` where ``deg`` is the per-row degree over
    the whole chunk and ``payload`` (fill pass only) carries the masked
    candidate arrays.  Degree and fill passes consume identical
    keystream words, so they agree by construction.
    """
    offs = spec.offsets()
    a, b = offs[rule.dst]
    lo, hi = max(a, r0), min(b, r1)
    deg_all = np.zeros(r1 - r0, np.int64)
    if lo >= hi:
        return deg_all, None
    rows = np.arange(lo, hi, dtype=np.int64)
    R = len(rows)
    sa, sb = offs[rule.src]
    n_src = sb - sa
    d2 = None

    if rule.fan_in:
        C = rule.fan_in
        sw = words(crng.rule_stream(ri, crng.SRC_OFF), rows, 0, C)
        rel = crng.uint_below(sw, n_src).astype(np.int64)
        if rule.no_self:
            # deterministic remap keeps the exact in-degree
            self_rel = rows[:, None] - sa
            rel = np.where(rel == self_rel, (rel + 1) % n_src, rel)
        src = sa + rel
        valid = np.ones((R, C), bool)
    elif rule.p > 0.0:
        lam = rule.p * n_src
        base = int(lam)
        thr = np.uint32(int(round((lam - base) * (1 << 24))))
        dw = words(crng.rule_stream(ri, crng.DEGREE_OFF), rows, 0, 2)
        extra = crng.u24(dw[:, 0]) < thr
        deg = base + extra.astype(np.int64)
        C = base + 1
        valid = np.arange(C, dtype=np.int64)[None, :] < deg[:, None]
        sw = words(crng.rule_stream(ri, crng.SRC_OFF), rows, 0, C)
        src = sa + crng.uint_below(sw, n_src).astype(np.int64)
        if rule.no_self:
            valid &= src != rows[:, None]
    else:  # distance kernel
        C = rule.candidates
        sw = words(crng.rule_stream(ri, crng.SRC_OFF), rows, 0, C)
        src = sa + crng.uint_below(sw, n_src).astype(np.int64)
        tgt_xyz = _coords_for_ids(spec, words, rows)
        src_xyz = _coords_for_ids(spec, words, src.ravel()).reshape(R, C, 3)
        d2 = ((src_xyz - tgt_xyz[:, None, :]) ** 2).sum(axis=-1)
        kern = rule.kernel
        p_acc = np.float32(kern.p_max) * np.clip(
            np.float32(1.0) - d2 / np.float32(kern.radius**2), 0.0, 1.0
        ).astype(np.float32)
        aw = words(crng.rule_stream(ri, crng.ACCEPT_OFF), rows, 0, C)
        valid = crng.uniform01(aw) < p_acc
        if rule.no_self:
            valid &= src != rows[:, None]

    deg_all[lo - r0 : hi - r0] = valid.sum(axis=1)
    if not fill:
        return deg_all, None

    # Weights: scale * f(mu + sigma * z), f = abs when weight_abs.
    if rule.weight_sigma:
        zw = words(
            crng.rule_stream(ri, crng.WEIGHT_OFF), rows, 0, C * crng.NORMAL_WORDS
        ).reshape(R, C, crng.NORMAL_WORDS)
        w = np.float32(rule.weight_mu) + np.float32(rule.weight_sigma) * crng.standard_normal(zw)
    else:
        w = np.full((R, C), rule.weight_mu, np.float32)
    if rule.weight_abs:
        w = np.abs(w)
    if rule.weight_scale != 1.0:
        w = w * np.float32(rule.weight_scale)

    if rule.delay_uniform:
        dlw = words(crng.rule_stream(ri, crng.DELAY_OFF), rows, 0, C)
        d = (1 + crng.uint_below(dlw, rule.delay_uniform)).astype(np.float32)
    elif rule.delay_distance:
        if d2 is None:  # fan_in/p rule with distance delays
            tgt_xyz = _coords_for_ids(spec, words, rows)
            src_xyz = _coords_for_ids(spec, words, src.ravel()).reshape(R, C, 3)
            d2 = ((src_xyz - tgt_xyz[:, None, :]) ** 2).sum(axis=-1)
        dm = np.float32(rule.delay_distance)
        d = np.clip(np.ceil(np.sqrt(d2) / np.float32(3.0**0.5) * dm), 1.0, dm)
        d = d.astype(np.float32)
    else:
        d = np.full((R, C), rule.delay, np.float32)

    payload = {
        "lo": lo - r0,
        "valid": valid,
        "src": src,
        "w": w.astype(np.float32),
        "d": d,
        "emodel": registry.edge_id(rule.synapse),
    }
    return deg_all, payload


def _fill_chunk(spec, words, registry, r0, r1):
    """All edges into rows [r0, r1): row-major, within-row source-sorted.

    Returns (counts (R,), col_idx, edge_model, edge_state) for the chunk.
    """
    R = r1 - r0
    payloads = []
    counts = np.zeros(R, np.int64)
    for ri, rule in enumerate(spec.rules):
        deg, payload = _rule_chunk(spec, words, ri, rule, r0, r1, registry, fill=True)
        counts += deg
        if payload is not None and payload["valid"].any():
            payloads.append(payload)
    max_se = registry.max_edge_state
    if not payloads:
        return (
            counts,
            np.zeros(0, np.int64),
            np.zeros(0, np.int32),
            np.zeros((0, max_se), np.float32),
        )
    rows_l, srcs, ws, ds, ems = [], [], [], [], []
    for p in payloads:
        ii, jj = np.nonzero(p["valid"])  # row-major within this rule
        rows_l.append(p["lo"] + ii)
        srcs.append(p["src"][ii, jj])
        ws.append(p["w"][ii, jj])
        ds.append(p["d"][ii, jj])
        ems.append(np.full(len(ii), p["emodel"], np.int32))
    rowf = np.concatenate(rows_l)
    srcf = np.concatenate(srcs)
    # stable (row, src) sort == from_edges' lexsort((nsrc, ndst)) order.  One
    # stable argsort of the key row * n + src gives the same permutation as
    # the reference's lexsort((srcf, rowf)) (same order, ties kept in input
    # order) in about a quarter of the time: the key arrives in one sorted
    # run per rule, which the stable sort merges.
    order = np.argsort(rowf * np.int64(spec.n) + srcf, kind="stable")
    estate = np.zeros((len(srcf), max_se), np.float32)
    estate[:, 0] = np.concatenate(ws)[order]
    estate[:, 1] = np.concatenate(ds)[order]
    return counts, srcf[order], np.concatenate(ems)[order], estate


# ---------------------------------------------------------------------------
# Partition / network assembly
# ---------------------------------------------------------------------------


def _block_bounds(n: int, k: int):
    base, rem = divmod(n, k)
    sizes = np.full(k, base, np.int64)
    sizes[:rem] += 1
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64), sizes


def build_partition(
    spec: RuleSpec,
    k: int,
    part_id: int,
    *,
    uniform: bool = False,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    path: str = "auto",
    device=None,
    registry=None,
    report: Optional[BuildReport] = None,
) -> DCSRPartition:
    """Emit partition ``part_id`` of the ``k``-way block partition of ``spec``.

    Only this partition's rows are ever touched; peak memory is one
    ``chunk_rows`` row-block plus the partition's own arrays.
    ``uniform=True`` appends the same isolated dummy vertices
    ``to_dcsr(..., uniform=True)`` would, so SPMD shard shapes match.
    ``report`` (a :class:`BuildReport`) accumulates the keystream's share.
    """
    if not (0 <= part_id < k):
        raise ValueError(f"part_id {part_id} out of range for k={k}")
    registry = registry or _default_registry()
    path, device = resolve_build_path(path, device)
    if report is None:
        report = BuildReport(path, None if device is None else str(device))
    words = _Words(spec.seed, path, device, report)
    n = spec.n
    bounds, sizes = _block_bounds(n, k)
    r_lo, r_hi = int(bounds[part_id]), int(bounds[part_id + 1])
    n_real = r_hi - r_lo
    if uniform:
        target = int(sizes.max())
        deficit = target - sizes
        pad = int(deficit[part_id])
        pad_gid0 = n + int(deficit[:part_id].sum())
        row_start = part_id * target
        if int(deficit.sum()):
            # Sources must carry *uniform-slot* labels (q*target + local),
            # matching from_edges' relabelling when pads interleave.  The
            # map is strictly monotonic so within-row order is preserved.
            def relabel(s):
                q = np.searchsorted(bounds, s, side="right") - 1
                return q * target + (s - bounds[q])
        else:
            relabel = None
    else:
        pad, pad_gid0, row_start = 0, 0, r_lo
        relabel = None

    chunk_rows = max(1, int(chunk_rows))
    chunks = list(range(r_lo, r_hi, chunk_rows))

    # Pass 1: exact per-row degrees -> row_ptr (exact-fit allocation).
    degrees = np.zeros(n_real + pad, np.int64)
    for c0 in chunks:
        c1 = min(c0 + chunk_rows, r_hi)
        for ri, rule in enumerate(spec.rules):
            deg, _ = _rule_chunk(spec, words, ri, rule, c0, c1, registry, fill=False)
            degrees[c0 - r_lo : c1 - r_lo] += deg
    row_ptr = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int64)
    m_p = int(row_ptr[-1])

    # Pass 2: fill preallocated arrays chunk by chunk.
    col_idx = np.empty(m_p, np.int64)
    edge_model = np.empty(m_p, np.int32)
    edge_state = np.empty((m_p, registry.max_edge_state), np.float32)
    n_tot = n_real + pad
    vtx_model = np.empty(n_tot, np.int32)
    vtx_state = np.zeros((n_tot, registry.max_vertex_state), np.float32)
    coords = np.zeros((n_tot, 3), np.float32)
    for c0 in chunks:
        c1 = min(c0 + chunk_rows, r_hi)
        counts, csrc, cem, ces = _fill_chunk(spec, words, registry, c0, c1)
        if relabel is not None:
            csrc = relabel(csrc)
        e0 = int(row_ptr[c0 - r_lo])
        e1 = e0 + len(csrc)
        assert counts.sum() == len(csrc) and e1 == int(row_ptr[c1 - r_lo])
        col_idx[e0:e1] = csrc
        edge_model[e0:e1] = cem
        edge_state[e0:e1] = ces
        vm, vs, cc = _vertex_block(spec, words, registry, c0, c1)
        vtx_model[c0 - r_lo : c1 - r_lo] = vm
        vtx_state[c0 - r_lo : c1 - r_lo] = vs
        coords[c0 - r_lo : c1 - r_lo] = cc

    global_ids = np.arange(r_lo, r_hi, dtype=np.int64)
    if pad:
        vtx_model[n_real:] = registry.vertex_id("lif")
        vtx_state[n_real:, 0] = _PAD_V
        vtx_state[n_real:, 1] = _PAD_REFRAC
        global_ids = np.concatenate(
            [global_ids, np.arange(pad_gid0, pad_gid0 + pad, dtype=np.int64)]
        )

    return DCSRPartition(
        part_id=part_id,
        row_start=row_start,
        row_ptr=row_ptr,
        col_idx=col_idx,
        vtx_model=vtx_model,
        vtx_state=vtx_state,
        edge_model=edge_model,
        edge_state=edge_state,
        coords=coords,
        global_ids=global_ids,
    )


def build_network(
    spec: RuleSpec,
    k: int = 1,
    *,
    uniform: bool = False,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    path: str = "auto",
    device=None,
) -> DCSRNetwork:
    """Build the full k-way network by per-partition emission.

    Bit-identical to ``to_dcsr(network_def(spec), k=k, uniform=uniform)``
    for every k, chunk size, and sampling path.  The keystream runs on
    ``device`` (the card by default; see :func:`resolve_build_path`).
    """
    t0 = time.perf_counter()
    path, device = resolve_build_path(path, device)
    report = BuildReport(path, None if device is None else str(device))
    registry = _default_registry()
    n = spec.n
    _, sizes = _block_bounds(n, k)
    if uniform:
        target = int(sizes.max())
        dist = (np.arange(k + 1, dtype=np.int64) * target)
    else:
        dist = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    parts = [
        build_partition(
            spec, k, p, uniform=uniform, chunk_rows=chunk_rows,
            path=path, device=device, registry=registry, report=report,
        )
        for p in range(k)
    ]
    # row_ptr degrees for padded rows are absent only when pad == 0; when
    # uniform, padded rows were appended with zero degree by construction.
    for part in parts:
        if part.n != len(part.row_ptr) - 1:
            raise AssertionError("partition row_ptr inconsistent")
    net = DCSRNetwork(dist=dist, parts=parts, registry=registry, meta=spec.meta())
    net.validate()
    # carry the generating spec (JSON form) so snapshots of this network
    # can regenerate a corrupt shard's topology bit-identically at restore
    # (io.dcsr_binary embeds it in the manifest, as the reference's does;
    # snn.supervisor.restore_resilient consumes it)
    from .rules import spec_to_dict

    net.rule_spec = {"spec": spec_to_dict(spec), "uniform": bool(uniform),
                     "k": int(k)}
    report.seconds = time.perf_counter() - t0
    net.build_report = report
    return net


def network_def(
    spec: RuleSpec,
    *,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    path: str = "auto",
    device=None,
):
    """Eager bridge: materialize the rule-built network as a legacy
    ``NetworkDef`` (whole network on host — for interop and tests)."""
    from ..snn.network import NetworkDef

    part = build_partition(
        spec, 1, 0, chunk_rows=chunk_rows, path=path, device=device
    )
    return NetworkDef(
        n=spec.n,
        src=part.col_idx.copy(),
        dst=part.edge_targets(),
        edge_state=part.edge_state,
        vtx_model=part.vtx_model,
        vtx_state=part.vtx_state,
        coords=part.coords,
        registry=_default_registry(),
        meta=spec.meta(),
        edge_model=part.edge_model,
    )
