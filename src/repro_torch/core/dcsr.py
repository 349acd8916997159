"""Distributed Compressed Sparse Row (dCSR) — the paper's core data layout.

A copy of ``repro.core.dcsr`` kept in the port, which imports nothing of
the JAX package; builders here and there give byte-identical arrays.

Rows are **target** vertices; the column array stores **global source** vertex
ids of incoming edges ("colocating a directed edge with its target vertex").
A k-way partition of the vertices induces the ``dist`` prefix array of size
k+1 over rows; the column/value arrays split along the same boundaries
(``edist``).  Vertex and edge state are tuples aligned with the row / column
arrays, typed through a :class:`~repro.core.state.ModelRegistry`.

Everything here is host-side numpy (network construction and
serialization; the edge sort runs ``torch.sort`` on the host); the simulation-facing, device-resident layout is derived in
:mod:`repro.core.ell`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .state import ModelRegistry, default_registry, EDGE_DELAY

Array = np.ndarray


def edge_order(nsrc: Array, ndst: Array, n: int) -> Array:
    """The permutation that sorts edges by (target, source), stable:
    ``np.lexsort((nsrc, ndst))``.  Where ``n * n`` fits in int64 it is one
    stable sort of the packed key ``ndst * n + nsrc`` (``torch.sort`` on the
    host's threads; the same permutation, since both sorts are stable and
    the key orders pairs as the lexsort does), else the lexsort itself."""
    if n and n > np.iinfo(np.int64).max // n:
        return np.lexsort((nsrc, ndst))
    key = torch.from_numpy(ndst * np.int64(n) + nsrc)
    return torch.sort(key, stable=True).indices.numpy()


@dataclasses.dataclass
class DCSRPartition:
    """One partition's slice of the global dCSR structure.

    All ``col_idx`` entries are *global* vertex ids (new labelling, i.e.
    partition-contiguous).  ``global_ids`` maps local row -> original vertex
    id from before partitioning, preserving interoperability with the
    un-partitioned network description.
    """

    part_id: int
    row_start: int  # global id of first owned vertex
    row_ptr: Array  # (n_p + 1,) int64, local offsets into col_idx
    col_idx: Array  # (m_p,) int64, global source ids
    vtx_model: Array  # (n_p,) int32 -> registry vertex model id
    vtx_state: Array  # (n_p, max_sv) float32, padded tuples
    edge_model: Array  # (m_p,) int32 -> registry edge model id
    edge_state: Array  # (m_p, max_se) float32, padded tuples
    coords: Array  # (n_p, 3) float32
    global_ids: Array  # (n_p,) int64 original vertex ids

    @property
    def n(self) -> int:
        return len(self.row_ptr) - 1

    @property
    def m(self) -> int:
        return len(self.col_idx)

    @property
    def row_end(self) -> int:
        return self.row_start + self.n

    def in_degree(self) -> Array:
        return np.diff(self.row_ptr)

    def edge_targets(self) -> Array:
        """Global target id per edge (expanded from row_ptr)."""
        return self.row_start + np.repeat(
            np.arange(self.n, dtype=np.int64), self.in_degree()
        )

    def validate(self, n_global: int) -> None:
        assert self.row_ptr[0] == 0 and self.row_ptr[-1] == self.m
        assert np.all(np.diff(self.row_ptr) >= 0), "row_ptr not monotone"
        if self.m:
            assert self.col_idx.min() >= 0
            assert self.col_idx.max() < n_global, "col_idx out of range"
        assert self.vtx_state.shape[0] == self.n
        assert self.edge_state.shape[0] == self.m
        assert self.coords.shape == (self.n, 3)


@dataclasses.dataclass
class DCSRNetwork:
    """The full k-way partitioned network: dist + per-partition slices."""

    dist: Array  # (k+1,) int64 vertex partition prefix ("dist" file)
    parts: List[DCSRPartition]
    registry: ModelRegistry
    meta: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def k(self) -> int:
        return len(self.parts)

    @property
    def n(self) -> int:
        return int(self.dist[-1])

    @property
    def m(self) -> int:
        return sum(p.m for p in self.parts)

    @property
    def edist(self) -> Array:
        """Edge partition prefix (m_1 + ... + m_k = m)."""
        return np.concatenate(
            [[0], np.cumsum([p.m for p in self.parts])]
        ).astype(np.int64)

    def validate(self) -> None:
        assert self.dist[0] == 0 and len(self.dist) == self.k + 1
        for p, part in enumerate(self.parts):
            assert part.part_id == p
            assert part.row_start == self.dist[p]
            assert part.n == self.dist[p + 1] - self.dist[p]
            part.validate(self.n)
        gids = np.concatenate([p.global_ids for p in self.parts])
        assert len(np.unique(gids)) == self.n, "global_ids not a permutation"

    # -- whole-network views (small nets / tests / interop) ----------------
    def to_global_csr(self) -> Tuple[Array, Array, Array, Array]:
        """(row_ptr, col_idx, edge_model, edge_state) over all partitions."""
        row_ptr = [np.zeros(1, dtype=np.int64)]
        off = 0
        for p in self.parts:
            row_ptr.append(p.row_ptr[1:] + off)
            off += p.m
        return (
            np.concatenate(row_ptr),
            np.concatenate([p.col_idx for p in self.parts]),
            np.concatenate([p.edge_model for p in self.parts]),
            np.concatenate([p.edge_state for p in self.parts]),
        )

    def max_delay(self) -> int:
        d = 1
        for p in self.parts:
            if p.m:
                d = max(d, int(p.edge_state[:, EDGE_DELAY].max()))
        return d


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------

def from_edges(
    n: int,
    src: Array,
    dst: Array,
    edge_state: Array,
    *,
    edge_model: Optional[Array] = None,
    vtx_model: Optional[Array] = None,
    vtx_state: Optional[Array] = None,
    coords: Optional[Array] = None,
    registry: Optional[ModelRegistry] = None,
    assignment: Optional[Array] = None,
    k: int = 1,
    meta: Optional[Dict[str, float]] = None,
) -> DCSRNetwork:
    """Build a partitioned DCSRNetwork from an edge list (COO -> dCSR).

    ``assignment`` maps original vertex id -> partition (default: block
    partition into ``k`` parts).  Vertices are relabelled partition-contiguous
    (stable order within a partition) per the dCSR convention.
    """
    registry = registry or default_registry()
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    m = len(src)
    assert len(dst) == m
    edge_state = np.ascontiguousarray(edge_state, dtype=np.float32)
    if edge_state.ndim == 1:
        edge_state = edge_state[:, None]
    max_se = registry.max_edge_state
    if edge_state.shape[1] < max_se:
        pad = np.zeros((m, max_se - edge_state.shape[1]), dtype=np.float32)
        edge_state = np.concatenate([edge_state, pad], axis=1)

    if edge_model is None:
        edge_model = np.full(m, registry.edge_id("syn_static"), dtype=np.int32)
    if vtx_model is None:
        vtx_model = np.full(n, 0, dtype=np.int32)
    max_sv = registry.max_vertex_state
    if vtx_state is None:
        vtx_state = np.zeros((n, max_sv), dtype=np.float32)
    elif vtx_state.shape[1] < max_sv:
        pad = np.zeros((n, max_sv - vtx_state.shape[1]), dtype=np.float32)
        vtx_state = np.concatenate([vtx_state, pad], axis=1)
    if coords is None:
        coords = np.zeros((n, 3), dtype=np.float32)

    if assignment is None:
        from .partition import block_partition

        assignment = block_partition(n, k)
    else:
        assignment = np.asarray(assignment, dtype=np.int64)
        k = int(assignment.max()) + 1 if len(assignment) else k

    # Relabel: new id = position in (partition-major, stable) order.
    order = np.argsort(assignment, kind="stable")  # original ids, new order
    new_id = np.empty(n, dtype=np.int64)
    new_id[order] = np.arange(n, dtype=np.int64)
    dist = np.concatenate(
        [[0], np.cumsum(np.bincount(assignment, minlength=k))]
    ).astype(np.int64)

    nsrc = new_id[src]
    ndst = new_id[dst]

    # Sort edges by (target, source) -> row-major CSR over new labels.
    # Edges already in that order (a repartition that keeps the labelling,
    # as merge_to_single of a block-partitioned net does) stay as they are:
    # the stable sort of sorted keys is the identity, and it is most of the
    # cost of a merge.
    d_dst = np.diff(ndst)
    if not ((d_dst >= 0).all() and ((d_dst > 0) | (np.diff(nsrc) >= 0)).all()):
        eorder = edge_order(nsrc, ndst, n)
        nsrc, ndst = nsrc[eorder], ndst[eorder]
        edge_state = edge_state[eorder]
        edge_model = edge_model[eorder]
    del d_dst

    counts = np.bincount(ndst, minlength=n)
    row_ptr_g = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    parts: List[DCSRPartition] = []
    for p in range(k):
        r0, r1 = int(dist[p]), int(dist[p + 1])
        e0, e1 = int(row_ptr_g[r0]), int(row_ptr_g[r1])
        orig = order[r0:r1]
        parts.append(
            DCSRPartition(
                part_id=p,
                row_start=r0,
                row_ptr=(row_ptr_g[r0 : r1 + 1] - row_ptr_g[r0]).copy(),
                col_idx=nsrc[e0:e1].copy(),
                vtx_model=vtx_model[orig].astype(np.int32),
                vtx_state=vtx_state[orig].astype(np.float32),
                edge_model=edge_model[e0:e1].copy(),
                edge_state=edge_state[e0:e1].copy(),
                coords=coords[orig].astype(np.float32),
                global_ids=orig.astype(np.int64),
            )
        )
    net = DCSRNetwork(dist=dist, parts=parts, registry=registry,
                      meta=dict(meta or {}))
    net.validate()
    return net


def to_edges(net: DCSRNetwork) -> Tuple[Array, Array, Array, Array]:
    """Inverse of :func:`from_edges` (in the *new* global labelling):
    returns (src, dst, edge_model, edge_state)."""
    srcs, dsts, models, states = [], [], [], []
    for p in net.parts:
        srcs.append(p.col_idx)
        dsts.append(p.edge_targets())
        models.append(p.edge_model)
        states.append(p.edge_state)
    return (
        np.concatenate(srcs) if srcs else np.zeros(0, np.int64),
        np.concatenate(dsts) if dsts else np.zeros(0, np.int64),
        np.concatenate(models) if models else np.zeros(0, np.int32),
        np.concatenate(states) if states else np.zeros((0, 0), np.float32),
    )


def repartition(net: DCSRNetwork, assignment: Array) -> DCSRNetwork:
    """Re-partition an existing network (the paper's 'inform a potential
    repartitioning ... to optimally fit different backends').

    ``assignment`` is over the network's *current* global labelling.  The
    returned network is relabelled; original ids are composed through
    ``global_ids`` so provenance is never lost.
    """
    src, dst, emodel, estate = to_edges(net)
    vtx_model = np.concatenate([p.vtx_model for p in net.parts])
    vtx_state = np.concatenate([p.vtx_state for p in net.parts])
    coords = np.concatenate([p.coords for p in net.parts])
    orig_ids = np.concatenate([p.global_ids for p in net.parts])
    new = from_edges(
        net.n, src, dst, estate,
        edge_model=emodel, vtx_model=vtx_model, vtx_state=vtx_state,
        coords=coords, registry=net.registry, assignment=assignment,
        meta=net.meta,
    )
    # compose provenance: new.global_ids currently index into net's labelling
    for p in new.parts:
        p.global_ids = orig_ids[p.global_ids]
    return new


def merge_to_single(net: DCSRNetwork) -> DCSRNetwork:
    """Collapse to k=1 (useful as the oracle in distributed-equivalence
    tests: same labelling, one partition)."""
    n = net.n
    return repartition(net, np.zeros(n, dtype=np.int64))
