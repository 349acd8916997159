"""Paper-faithful plain-text dCSR serialization (Section 3 of the paper).

A copy of the reference's ``repro/io/dcsr_text.py`` over the port's
``core``: both packages write the same bytes and read each other's files.

Six file kinds, per network ``<name>`` under a directory:

  <name>.dist       k, n, m + vertex/edge partition prefix arrays
  <name>.model      model dictionary: identifier -> tuple size + shared
                    params; plus ``@meta``/``@layout``/``@time`` lines
  <name>.adjcy.<p>  one line per local vertex (implicit row = line number,
                    the ParMETIS shortcut): incoming source ids, one entry
                    per edge (multapses repeat), followed by outgoing-only
                    neighbor ids (the symmetrized entries whose state line
                    carries the paper's ``none`` marker)
  <name>.coord.<p>  x y z per local vertex (geometric/voxel partitioner input)
  <name>.state.<p>  per local vertex: vertex model id + state tuple, then
                    edge model id + state tuple per incoming edge (aligned
                    with the adjacency line), then ``none`` per outgoing-only
                    neighbor
  <name>.event.<p>  in-flight events: ``src t_arr kind tgt weight``
  <name>.remap.<p>  (extension) permanent pre-partitioning vertex id per
                    local row — provenance that makes noise streams and
                    elastic resharding bit-exact across reload; absent in
                    the paper's format description (STACS keeps the
                    equivalent mapping internally), harmless to ignore

Each partition's files are written/read independently (the paper's parallel
I/O property); in a multi-process deployment every rank handles exactly its
``.{adjcy,coord,state,event}.<p>`` set.  Symmetrization (outgoing-only
entries) is computed from the in-memory transpose here; on a real cluster it
is one all-to-all of edge endpoints at save time.

Plain text is deliberately the paper's choice ("less memory efficient
on-disk than in simulation ... we opt to serialize to plain-text files for
portability"); :mod:`repro_torch.io.dcsr_binary` is the production fast path.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.dcsr import DCSRNetwork, DCSRPartition
from ..core.events import EVENT_DTYPE
from ..core.state import ModelRegistry, NONE_MODEL
from .durability import write_bytes_verified


def _fmt(x: float) -> str:
    return format(float(x), ".9g")


def _write_text(full: str, lines: List[str]) -> int:
    """Persist one textual artifact durably (CRC read-back verify plus
    the ``text_write`` fault hook) and return its byte size."""
    data = ("\n".join(lines) + "\n" if lines else "").encode()
    write_bytes_verified(full, data, "text_write")
    return len(data)


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------

def save_text(
    net: DCSRNetwork,
    path: str,
    name: str = "net",
    events_by_part: Optional[Sequence[np.ndarray]] = None,
    t_now: int = 0,
) -> Dict[str, int]:
    """Serialize; returns bytes written per file kind (the benchmark reads
    this for the paper's linear-in-synapses claim).  Each file is built
    in memory and persisted via :func:`durability.write_bytes_verified`
    (the ``text_write`` site), keeping every on-disk artifact CRC-checked
    and fault-injectable."""
    os.makedirs(path, exist_ok=True)
    sizes: Dict[str, int] = {}

    # .dist
    sizes[".dist"] = _write_text(os.path.join(path, f"{name}.dist"), [
        f"{net.k} {net.n} {net.m}",
        " ".join(str(int(x)) for x in net.dist),
        " ".join(str(int(x)) for x in net.edist),
    ])

    # .model
    model_lines: List[str] = []
    for mname, kind, size, params in net.registry.to_entries():
        pstr = " ".join(f"{k}={_fmt(v)}" for k, v in sorted(params.items()))
        model_lines.append(f"{mname} {kind} {size} {pstr}".rstrip())
    for spec in list(net.registry.vertex_models()) + list(
        net.registry.edge_models()
    ):
        if spec.state_vars:
            model_lines.append(
                f"@layout {spec.name} {','.join(spec.state_vars)}"
            )
    for k, v in sorted(net.meta.items()):
        model_lines.append(f"@meta {k}={_fmt(v)}")
    model_lines.append(f"@time {int(t_now)}")
    sizes[".model"] = _write_text(
        os.path.join(path, f"{name}.model"), model_lines
    )

    # transpose: outgoing-only neighbors per (global) vertex
    out_only = _outgoing_only(net)

    vnames = [s.name for s in net.registry.vertex_models()]
    enames = [s.name for s in net.registry.edge_models()]
    vsizes = [s.state_size for s in net.registry.vertex_models()]
    esizes = [s.state_size for s in net.registry.edge_models()]

    for part in net.parts:
        sfx = f".{part.part_id}"
        adjcy: List[str] = []
        coord: List[str] = []
        state: List[str] = []
        for r in range(part.n):
            e0, e1 = int(part.row_ptr[r]), int(part.row_ptr[r + 1])
            incoming = part.col_idx[e0:e1]
            extra = out_only.get(part.row_start + r, ())
            adjcy.append(" ".join(
                [str(int(c)) for c in incoming]
                + [str(int(c)) for c in extra]
            ))
            coord.append(" ".join(_fmt(x) for x in part.coords[r]))
            vm = int(part.vtx_model[r])
            tokens = [vnames[vm]] + [
                _fmt(x) for x in part.vtx_state[r, : vsizes[vm]]
            ]
            for e in range(e0, e1):
                em = int(part.edge_model[e])
                tokens.append(enames[em])
                tokens += [
                    _fmt(x) for x in part.edge_state[e, : esizes[em]]
                ]
            tokens += [NONE_MODEL] * len(extra)
            state.append(" ".join(tokens))
        for kind, lines in ((".adjcy", adjcy), (".coord", coord),
                            (".state", state)):
            sizes[kind] = sizes.get(kind, 0) + _write_text(
                os.path.join(path, f"{name}{kind}{sfx}"), lines,
            )

        sizes[".remap"] = sizes.get(".remap", 0) + _write_text(
            os.path.join(path, f"{name}.remap{sfx}"),
            [str(int(g)) for g in part.global_ids],
        )

        evs = (
            events_by_part[part.part_id]
            if events_by_part is not None
            else np.zeros(0, EVENT_DTYPE)
        )
        sizes[".event"] = sizes.get(".event", 0) + _write_text(
            os.path.join(path, f"{name}.event{sfx}"),
            [
                f"{int(e['src'])} {int(e['t_arr'])} {e['kind']} "
                f"{int(e['tgt'])} {_fmt(e['weight'])}"
                for e in evs
            ],
        )
    return sizes


def _outgoing_only(net: DCSRNetwork) -> Dict[int, Tuple[int, ...]]:
    """For each global vertex: targets it projects to but does not receive
    from (the symmetrized 'none' entries)."""
    from ..core.dcsr import to_edges

    src, dst, _, _ = to_edges(net)
    has_incoming = set(zip(src.tolist(), dst.tolist()))
    out: Dict[int, List[int]] = {}
    for s, d in zip(src.tolist(), dst.tolist()):
        # edge s -> d; vertex s lists d unless d -> s exists as an edge
        if (d, s) not in has_incoming:
            out.setdefault(s, []).append(d)
    return {k: tuple(sorted(set(v))) for k, v in out.items()}


# ---------------------------------------------------------------------------
# Load
# ---------------------------------------------------------------------------

def load_text(
    path: str, name: str = "net"
) -> Tuple[DCSRNetwork, List[np.ndarray], int]:
    """Reconstruct (network, events_by_part, t_now).  Each partition's files
    are parsed independently (parallel-ingest property)."""
    with open(os.path.join(path, f"{name}.dist")) as f:
        k, n, m = (int(x) for x in f.readline().split())
        dist = np.array([int(x) for x in f.readline().split()], np.int64)
        edist = np.array([int(x) for x in f.readline().split()], np.int64)
    registry, meta, layouts, t_now = _load_model(
        os.path.join(path, f"{name}.model")
    )
    vname_to_id = {
        s.name: i for i, s in enumerate(registry.vertex_models())
    }
    ename_to_id = {s.name: i for i, s in enumerate(registry.edge_models())}
    vsize = {s.name: s.state_size for s in registry.vertex_models()}
    esize = {s.name: s.state_size for s in registry.edge_models()}
    max_sv, max_se = registry.max_vertex_state, registry.max_edge_state

    parts: List[DCSRPartition] = []
    events: List[np.ndarray] = []
    for p in range(k):
        n_p = int(dist[p + 1] - dist[p])
        coords = np.loadtxt(
            os.path.join(path, f"{name}.coord.{p}"), dtype=np.float32,
            ndmin=2,
        ).reshape(n_p, 3)
        row_counts = np.zeros(n_p, np.int64)
        cols: List[int] = []
        vtx_model = np.zeros(n_p, np.int32)
        vtx_state = np.zeros((n_p, max_sv), np.float32)
        emodels: List[int] = []
        estates: List[List[float]] = []
        with open(os.path.join(path, f"{name}.adjcy.{p}")) as fa, open(
            os.path.join(path, f"{name}.state.{p}")
        ) as fs:
            for r in range(n_p):
                adj = [int(x) for x in fa.readline().split()]
                toks = fs.readline().split()
                i = 0
                vm = toks[i]
                i += 1
                vtx_model[r] = vname_to_id[vm]
                sv = vsize[vm]
                vtx_state[r, :sv] = [float(x) for x in toks[i : i + sv]]
                i += sv
                e_here = 0
                while i < len(toks):
                    em = toks[i]
                    i += 1
                    if em == NONE_MODEL:
                        continue  # outgoing-only marker: not an in-edge
                    se = esize[em]
                    st = [float(x) for x in toks[i : i + se]]
                    i += se
                    emodels.append(ename_to_id[em])
                    estates.append(st + [0.0] * (max_se - se))
                    cols.append(adj[e_here])
                    e_here += 1
                row_counts[r] = e_here
        row_ptr = np.concatenate([[0], np.cumsum(row_counts)]).astype(
            np.int64
        )
        remap_path = os.path.join(path, f"{name}.remap.{p}")
        if os.path.exists(remap_path):
            gids = np.loadtxt(remap_path, dtype=np.int64, ndmin=1)
        else:
            gids = np.arange(dist[p], dist[p + 1], dtype=np.int64)
        parts.append(
            DCSRPartition(
                part_id=p,
                row_start=int(dist[p]),
                row_ptr=row_ptr,
                col_idx=np.asarray(cols, np.int64),
                vtx_model=vtx_model,
                vtx_state=vtx_state,
                edge_model=np.asarray(emodels, np.int32),
                edge_state=(
                    np.asarray(estates, np.float32).reshape(-1, max_se)
                    if estates
                    else np.zeros((0, max_se), np.float32)
                ),
                coords=coords,
                global_ids=gids,
            )
        )
        evs = []
        with open(os.path.join(path, f"{name}.event.{p}")) as fe:
            for line in fe:
                s, t_arr, kind, tgt, w = line.split()
                evs.append((int(s), int(t_arr), kind, int(tgt), float(w)))
        events.append(np.array(evs, dtype=EVENT_DTYPE))
    net = DCSRNetwork(dist=dist, parts=parts, registry=registry, meta=meta)
    net.validate()
    assert np.array_equal(net.edist, edist), "edge dist mismatch on load"
    return net, events, t_now


def _load_model(path: str):
    entries = []
    layouts: Dict[str, Tuple[str, ...]] = {}
    meta: Dict[str, float] = {}
    t_now = 0
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            if toks[0] == "@layout":
                layouts[toks[1]] = tuple(toks[2].split(","))
            elif toks[0] == "@meta":
                k, v = toks[1].split("=")
                meta[k] = float(v)
            elif toks[0] == "@time":
                t_now = int(toks[1])
            else:
                name, kind, size = toks[0], toks[1], int(toks[2])
                params = {}
                for t in toks[3:]:
                    k, v = t.split("=")
                    params[k] = float(v)
                entries.append((name, kind, size, params))
    reg = ModelRegistry.from_entries(entries, var_names=layouts)
    return reg, meta, layouts, t_now
