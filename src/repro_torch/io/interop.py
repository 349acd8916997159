"""Interoperability adapters (paper Section 4).

A copy of the reference's ``repro/io/interop.py`` over the port's ``core``.

The paper argues dCSR is "relatively straightforward to interoperate with
popular graph analysis packages such as NetworkX and its directed graph data
structure".  NetworkX is not installed in this environment, so we interop at
the *data-structure* level it defines: adjacency dicts
(``{u: {v: {attrs}}}``) and edge lists — what ``nx.DiGraph(adj)`` consumes
directly — plus ParMETIS-style (xadj, adjncy, vtxdist) triples for graph
partitioners.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..core.dcsr import DCSRNetwork, from_edges, to_edges
from ..core.state import EDGE_WEIGHT, EDGE_DELAY


def to_adjacency_dict(net: DCSRNetwork) -> Dict[int, Dict[int, Dict]]:
    """Directed adjacency-of-dicts (NetworkX DiGraph input format).
    Multapses collapse to the last edge's attrs with a 'multiplicity'."""
    src, dst, _, estate = to_edges(net)
    adj: Dict[int, Dict[int, Dict]] = {i: {} for i in range(net.n)}
    for s, d, st in zip(src.tolist(), dst.tolist(), estate):
        e = adj[s].setdefault(int(d), dict(multiplicity=0))
        e["weight"] = float(st[EDGE_WEIGHT])
        e["delay"] = float(st[EDGE_DELAY])
        e["multiplicity"] += 1
    return adj


def from_adjacency_dict(
    adj: Dict[int, Dict[int, Dict]], k: int = 1, **kwargs
) -> DCSRNetwork:
    srcs, dsts, ws, ds = [], [], [], []
    n = max(adj.keys(), default=-1) + 1
    for s, nbrs in adj.items():
        for d, attrs in nbrs.items():
            n = max(n, d + 1)
            # absent multiplicity means one edge; an explicit 0 means NO
            # edge (it used to be coerced to 1 via `or 1`)
            mult = attrs.get("multiplicity")
            for _ in range(1 if mult is None else int(mult)):
                srcs.append(s)
                dsts.append(d)
                ws.append(float(attrs.get("weight", 1.0)))
                ds.append(float(attrs.get("delay", 1.0)))
    estate = np.stack(
        [np.asarray(ws, np.float32), np.asarray(ds, np.float32)], axis=1
    ) if srcs else np.zeros((0, 2), np.float32)
    return from_edges(
        n, np.asarray(srcs, np.int64), np.asarray(dsts, np.int64), estate,
        k=k, **kwargs,
    )


def to_parmetis(net: DCSRNetwork) -> Tuple[np.ndarray, List[np.ndarray],
                                           List[np.ndarray]]:
    """(vtxdist, xadj_per_part, adjncy_per_part) — the dCSR triple ParMETIS
    ingests (symmetrized union of in/out neighbours, no self-loops)."""
    src, dst, _, _ = to_edges(net)
    und = {}
    for s, d in zip(src.tolist(), dst.tolist()):
        if s == d:
            continue
        und.setdefault(s, set()).add(d)
        und.setdefault(d, set()).add(s)
    xadjs, adjncys = [], []
    for p in net.parts:
        xadj = [0]
        adjncy: List[int] = []
        for r in range(p.n):
            nbrs = sorted(und.get(p.row_start + r, ()))
            adjncy.extend(nbrs)
            xadj.append(len(adjncy))
        xadjs.append(np.asarray(xadj, np.int64))
        adjncys.append(np.asarray(adjncy, np.int64))
    return net.dist.copy(), xadjs, adjncys
