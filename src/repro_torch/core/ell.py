"""TPU-native repacking of a dCSR partition: delay-bucketed blocked ELL.

A copy of ``repro.core.ell`` kept in the port, which imports nothing of
the JAX package; builders here and there give byte-identical arrays.

CSR's ragged row iteration is hostile to the TPU VPU (variable trip counts,
unaligned loads).  At simulation setup we repack each partition's CSR into a
small set of *delay buckets*; within a bucket every row is padded to a
lane-aligned fixed width K_b, yielding dense ``(R, K_b)`` panels of global
column ids and weights that a Pallas kernel streams through VMEM.

``edge_index`` maps every (row, slot) back to the originating edge position in
the partition's CSR arrays, so plastic weights round-trip losslessly into the
dCSR serialization (ELL is a *view* for compute; dCSR stays the source of
truth on disk).

Heavy-row splitting (``max_k``) bounds padding waste for skewed in-degree
distributions: rows wider than ``max_k`` are split into virtual rows and the
simulator re-reduces with a segment-sum (``row_map``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .dcsr import DCSRPartition
from .state import EDGE_WEIGHT, EDGE_DELAY

Array = np.ndarray


def _align_up(x: int, a: int) -> int:
    return ((x + a - 1) // a) * a


@dataclasses.dataclass
class ELLBucket:
    """One delay bucket: dense (R, K) panels (R = padded virtual rows)."""

    delay: int  # integer steps
    cols: Array  # (R, K) int32 global source ids (0 where invalid)
    weights: Array  # (R, K) float32 (0 where invalid)
    valid: Array  # (R, K) bool
    edge_index: Array  # (R, K) int64 -> partition CSR edge position, -1 pad
    row_map: Array  # (R,) int32 virtual row -> actual local row
    identity_rows: bool  # row_map[i] == i for i < n_rows

    @property
    def shape(self):
        return self.cols.shape


@dataclasses.dataclass
class DelayELL:
    """All buckets for one partition."""

    n_rows: int  # n_p (unpadded local rows)
    n_global: int  # global vertex count (gather vector length)
    buckets: List[ELLBucket]
    nnz: int  # true edge count m_p

    @property
    def max_delay(self) -> int:
        return max((b.delay for b in self.buckets), default=1)

    @property
    def padded_slots(self) -> int:
        return sum(int(np.prod(b.shape)) for b in self.buckets)

    @property
    def fill_factor(self) -> float:
        """nnz / padded slots (1.0 = no padding waste)."""
        s = self.padded_slots
        return self.nnz / s if s else 1.0

    def scatter_weights_back(self, part: DCSRPartition) -> None:
        """Write (possibly plasticity-updated) ELL weights into the dCSR
        partition's edge_state, in place."""
        for b in self.buckets:
            sel = b.edge_index >= 0
            part.edge_state[b.edge_index[sel], EDGE_WEIGHT] = b.weights[sel]

    def update_bucket_weights(self, new_weights: List[Array]) -> None:
        for b, w in zip(self.buckets, new_weights):
            b.weights = np.where(b.valid, np.asarray(w, np.float32), 0.0)


def build_delay_ell(
    part: DCSRPartition,
    n_global: int,
    *,
    align_k: int = 128,
    align_rows: int = 8,
    max_k: Optional[int] = None,
    min_delay: int = 1,
) -> DelayELL:
    """Repack one partition (see module docstring).

    ``align_k``/``align_rows`` default to TPU lane/sublane alignment; tests
    use small values to keep oracles readable.
    """
    n_p = part.n
    delays = part.edge_state[:, EDGE_DELAY].astype(np.int64)
    delays = np.maximum(delays, min_delay)
    rows_of_edge = np.repeat(
        np.arange(n_p, dtype=np.int64), part.in_degree()
    )
    buckets: List[ELLBucket] = []
    for d in np.unique(delays) if part.m else []:
        sel = np.flatnonzero(delays == d)  # sorted by (row, col) already
        r = rows_of_edge[sel]
        counts = np.bincount(r, minlength=n_p)
        starts = np.cumsum(counts) - counts
        pos = np.arange(len(sel)) - starts[r]

        if max_k is not None and counts.max() > max_k:
            # Split heavy rows into virtual rows of width <= max_k.
            vrow_of = r * 0  # placeholder, computed below
            n_splits = (counts + max_k - 1) // max_k  # per actual row
            n_splits = np.maximum(n_splits, 1)
            vrow_base = np.cumsum(n_splits) - n_splits  # first vrow per row
            vrow_of = vrow_base[r] + pos // max_k
            vpos = pos % max_k
            R_v = int(n_splits.sum())
            K = _align_up(min(int(counts.max()), max_k), align_k)
            R = _align_up(R_v, align_rows)
            row_map = np.zeros(R, dtype=np.int32)
            row_map[:R_v] = np.repeat(
                np.arange(n_p, dtype=np.int32), n_splits
            )
            identity = False
            rr, pp = vrow_of, vpos
        else:
            K = _align_up(max(int(counts.max()), 1), align_k)
            R = _align_up(n_p, align_rows)
            row_map = np.arange(R, dtype=np.int32)
            row_map[n_p:] = 0  # padded rows accumulate nothing (valid=False)
            identity = True
            rr, pp = r, pos

        cols = np.zeros((R, K), dtype=np.int32)
        weights = np.zeros((R, K), dtype=np.float32)
        valid = np.zeros((R, K), dtype=bool)
        eidx = np.full((R, K), -1, dtype=np.int64)
        cols[rr, pp] = part.col_idx[sel].astype(np.int32)
        weights[rr, pp] = part.edge_state[sel, EDGE_WEIGHT]
        valid[rr, pp] = True
        eidx[rr, pp] = sel
        buckets.append(
            ELLBucket(
                delay=int(d), cols=cols, weights=weights, valid=valid,
                edge_index=eidx, row_map=row_map, identity_rows=identity,
            )
        )
    return DelayELL(
        n_rows=n_p, n_global=n_global, buckets=buckets, nnz=part.m
    )
