"""Vertex partitioners for dCSR.

A copy of ``repro.core.partition`` kept in the port, which imports nothing of
the JAX package; builders here and there give byte-identical arrays.

The paper leans on the ParMETIS lineage for partitioning and explicitly calls
out geometric fallbacks ("voxel-based partitioning") for networks too large
for advanced partitioners.  We provide:

* ``block_partition``   — contiguous equal ranges (ParMETIS default input dist)
* ``hash_partition``    — seeded random assignment (load-balance baseline)
* ``voxel_partition``   — the paper's voxel fallback: bin coords on a grid,
                          order voxels, greedy-fill partitions to balance
* ``rcb_partition``     — recursive coordinate bisection with optional
                          per-vertex weights (weighted median splits)
* ``rate_rebalance``    — straggler mitigation: re-weight RCB by measured
                          spike rates / compute cost and return a new
                          assignment (feeds :func:`repro.core.dcsr.repartition`)

All return an int64 assignment array over vertex ids.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

Array = np.ndarray


def block_partition(n: int, k: int) -> Array:
    """Contiguous ranges of sizes n_i with |n_i - n/k| <= 1."""
    base, rem = divmod(n, k)
    sizes = np.full(k, base, dtype=np.int64)
    sizes[:rem] += 1
    return np.repeat(np.arange(k, dtype=np.int64), sizes)


def hash_partition(n: int, k: int, seed: int = 0) -> Array:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    out = np.empty(n, dtype=np.int64)
    out[perm] = block_partition(n, k)
    return out


def voxel_partition(
    coords: Array, k: int, grid: Optional[Tuple[int, int, int]] = None
) -> Array:
    """Paper's fallback: voxelize space, then greedy-fill voxels into k parts.

    Voxels are visited in lexicographic (z-major) order; each partition takes
    whole voxels until it reaches its quota (ceil(n/k)), so partitions are
    spatially compact unions of voxels.
    """
    n = len(coords)
    if grid is None:
        g = max(1, int(np.ceil((4 * k) ** (1 / 3))))
        grid = (g, g, g)
    lo = coords.min(axis=0)
    hi = coords.max(axis=0)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    ijk = np.minimum(
        ((coords - lo) / span * np.asarray(grid)).astype(np.int64),
        np.asarray(grid, dtype=np.int64) - 1,
    )
    voxel_id = (ijk[:, 0] * grid[1] + ijk[:, 1]) * grid[2] + ijk[:, 2]
    order = np.argsort(voxel_id, kind="stable")
    quota = int(np.ceil(n / k))
    out = np.empty(n, dtype=np.int64)
    out[order] = np.minimum(np.arange(n) // quota, k - 1)
    # Snap voxel boundaries: keep whole voxels together where possible by
    # assigning each voxel to the partition holding the majority of it.
    vids = voxel_id[order]
    parts = out[order]
    boundaries = np.flatnonzero(np.diff(vids)) + 1
    seg_starts = np.concatenate([[0], boundaries])
    seg_ends = np.concatenate([boundaries, [n]])
    for s, e in zip(seg_starts, seg_ends):
        # majority partition of this voxel segment
        vals, cnt = np.unique(parts[s:e], return_counts=True)
        parts[s:e] = vals[np.argmax(cnt)]
    out[order] = parts
    return _rebalance_to_k(out, k)


def rcb_partition(
    coords: Array, k: int, weights: Optional[Array] = None
) -> Array:
    """Recursive coordinate bisection with weighted median splits.

    Handles non-power-of-two ``k`` by splitting child counts proportionally
    (k -> ceil(k/2), floor(k/2)) and target weight accordingly.
    """
    n = len(coords)
    w = np.ones(n, dtype=np.float64) if weights is None else np.asarray(
        weights, dtype=np.float64
    )
    out = np.zeros(n, dtype=np.int64)

    def recurse(idx: Array, k_local: int, base: int) -> None:
        if k_local <= 1 or len(idx) == 0:
            out[idx] = base
            return
        kl = (k_local + 1) // 2
        kr = k_local - kl
        c = coords[idx]
        dim = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, dim], kind="stable")
        cw = np.cumsum(w[idx][order])
        target = cw[-1] * kl / k_local
        split = int(np.searchsorted(cw, target))
        split = min(max(split, 1), len(idx) - 1)
        left = idx[order[:split]]
        right = idx[order[split:]]
        recurse(left, kl, base)
        recurse(right, kr, base + kl)

    recurse(np.arange(n, dtype=np.int64), k, 0)
    return out


def rate_rebalance(
    coords: Array,
    k: int,
    rates: Array,
    in_degree: Optional[Array] = None,
    alpha: float = 1.0,
) -> Array:
    """Straggler mitigation: weight = in_degree + alpha * rate * in_degree.

    A partition's per-step cost is dominated by synaptic events processed
    (in-degree x presynaptic rate) plus neuron updates; reweighting RCB by the
    measured rates equalizes *work*, not just vertex counts.
    """
    rates = np.asarray(rates, dtype=np.float64)
    deg = (
        np.ones_like(rates)
        if in_degree is None
        else np.asarray(in_degree, dtype=np.float64)
    )
    weights = deg * (1.0 + alpha * rates) + 1.0
    return rcb_partition(coords, k, weights=weights)


# ---------------------------------------------------------------------------
# Quality metrics (benchmarks/partition_quality.py reads these)
# ---------------------------------------------------------------------------

def balance(assignment: Array, k: int, weights: Optional[Array] = None) -> float:
    """max part weight / mean part weight (1.0 = perfect)."""
    w = np.ones(len(assignment)) if weights is None else weights
    sums = np.bincount(assignment, weights=w, minlength=k)
    return float(sums.max() / max(sums.mean(), 1e-12))


def edge_cut(src: Array, dst: Array, assignment: Array) -> float:
    """Fraction of edges crossing partitions."""
    if len(src) == 0:
        return 0.0
    return float(np.mean(assignment[src] != assignment[dst]))


def _rebalance_to_k(assignment: Array, k: int) -> Array:
    """Ensure every partition id in [0,k) is used and sizes stay sane by
    moving overflow from the largest parts to empty ones."""
    counts = np.bincount(assignment, minlength=k)
    empties = [p for p in range(k) if counts[p] == 0]
    for p in empties:
        donor = int(np.argmax(counts))
        take = counts[donor] // 2
        if take == 0:
            continue
        idx = np.flatnonzero(assignment == donor)[:take]
        assignment[idx] = p
        counts[donor] -= take
        counts[p] += take
    return assignment
