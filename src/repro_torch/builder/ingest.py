"""Chunked streaming ingest of on-disk dCSR snapshots.

A copy of the reference's ``repro/builder/ingest.py`` over the port's
``core.dcsr`` and ``io.dcsr_binary`` (numpy only, no tensor): it reads the
same format 1.0 files, so it streams either package's snapshots.

``np.savez`` stores members uncompressed (ZIP_STORED), so a shard's
arrays can be read *by row range* straight out of the zip member: parse
the npy header once, then seek to ``data_start + r0 * rowbytes``.
:class:`SnapshotReader` exposes that as ``iter_rows(p, chunk_rows=...)``
— at no point does more than one chunk plus one assembled partition live
in host memory.

Three loaders build on the reader, all bit-identical to the eager
``io.dcsr_binary.load_binary`` (same bytes, same dtypes, same order):

- :func:`load_binary_streamed`  — every partition, assembled one at a
  time from row chunks (native-k streaming restore).
- :func:`load_merged_streamed`  — the k=1 merge, assembled directly by
  concatenating partitions in row order.  This equals
  ``core.dcsr.merge_to_single`` bit-for-bit *without* the COO round trip
  because dCSR snapshots keep within-row edges source-sorted (the
  ``from_edges`` invariant), so the stable ``(row, src)`` re-sort the
  eager merge performs is the identity.
- ``Session.restore(path, streaming=True)`` — routes either loader
  through ``io.dcsr_binary.load_latest_valid``'s CRC/``.old``-fallback
  walk via its ``loader=`` hook.

CRC verification streams each shard file in 1 MB pieces before its first
member read (shared ``io.dcsr_binary`` machinery), preserving the
corruption-detection contract without materializing the file.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zipfile
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
from numpy.lib import format as npf

from ..core.dcsr import DCSRNetwork, DCSRPartition
from ..io.dcsr_binary import (
    check_format_version, check_shard_crc, registry_from_manifest,
)

DEFAULT_CHUNK_ROWS = 8192

# Arrays sized by the partition's row count (chunked by vertex rows),
# by its edge count (chunked by row_ptr edge ranges), and the small
# whole-partition runtime arrays (loaded in one piece).
_ROW_ARRAYS = ("vtx_model", "vtx_state", "coords", "global_ids")
_EDGE_ARRAYS = ("col_idx", "edge_model", "edge_state")


@dataclasses.dataclass
class RowChunk:
    """One contiguous block of a partition's dCSR rows.

    ``row_ptr`` is local to the chunk (``row_ptr[0] == 0``); ``e0`` is
    the chunk's edge offset within the partition.  Arrays may be
    read-only views over the decode buffer — copy before mutating.
    """

    part_id: int
    row0: int  # first local row of the chunk
    e0: int  # edge offset of the chunk within the partition
    row_ptr: np.ndarray  # (rows + 1,) int64, chunk-local
    col_idx: np.ndarray
    edge_model: np.ndarray
    edge_state: np.ndarray
    vtx_model: np.ndarray
    vtx_state: np.ndarray
    coords: np.ndarray
    global_ids: np.ndarray

    @property
    def rows(self) -> int:
        return len(self.row_ptr) - 1


class _Member:
    """Row-range reader over one uncompressed npy member of a shard zip."""

    def __init__(self, zf: zipfile.ZipFile, name: str):
        self.f = zf.open(name)
        version = npf.read_magic(self.f)
        if version == (1, 0):
            self.shape, fortran, self.dtype = npf.read_array_header_1_0(self.f)
        elif version == (2, 0):
            self.shape, fortran, self.dtype = npf.read_array_header_2_0(self.f)
        else:
            raise ValueError(f"unsupported npy version {version} in {name}")
        if fortran:
            raise ValueError(f"Fortran-order member {name} not streamable")
        self.data_start = self.f.tell()
        self.row_elems = int(np.prod(self.shape[1:], dtype=np.int64)) if self.shape else 1
        self.row_bytes = self.row_elems * self.dtype.itemsize

    def read_rows(self, r0: int, r1: int) -> np.ndarray:
        """Rows [r0, r1) along axis 0, decoded straight from the member."""
        count = r1 - r0
        if count <= 0:
            return np.zeros((0,) + tuple(self.shape[1:]), self.dtype)
        self.f.seek(self.data_start + r0 * self.row_bytes)
        buf = self.f.read(count * self.row_bytes)
        if len(buf) != count * self.row_bytes:
            raise IOError(
                f"short read: wanted rows [{r0}, {r1}) "
                f"({count * self.row_bytes} bytes), got {len(buf)}"
            )
        return np.frombuffer(buf, self.dtype).reshape((count,) + tuple(self.shape[1:]))

    def read_all(self) -> np.ndarray:
        return self.read_rows(0, int(self.shape[0]) if self.shape else 1)


class SnapshotReader:
    """Chunked reader over one on-disk dCSR snapshot directory."""

    def __init__(self, path: str, verify: bool = True):
        self.path = os.fspath(path)
        with open(os.path.join(self.path, "manifest.json")) as f:
            self.manifest = json.load(f)
        check_format_version(self.manifest, source=self.path)
        self.registry = registry_from_manifest(self.manifest)
        self.k = int(self.manifest["k"])
        self.n = int(self.manifest["n"])
        self.m = int(self.manifest["m"])
        self.dist = np.asarray(self.manifest["dist"], np.int64)
        self.meta = self.manifest["meta"]
        self.t_now = int(self.manifest["t_now"])
        self.verify = verify
        self._verified: set = set()
        self._zips: Dict[int, zipfile.ZipFile] = {}

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        for zf in self._zips.values():
            zf.close()
        self._zips.clear()

    def __enter__(self) -> "SnapshotReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- shard access ------------------------------------------------------
    def _zip(self, p: int) -> zipfile.ZipFile:
        if not (0 <= p < self.k):
            raise ValueError(f"partition {p} out of range for k={self.k}")
        if self.verify and p not in self._verified:
            check_shard_crc(self.path, p, self.manifest)
            self._verified.add(p)
        if p not in self._zips:
            self._zips[p] = zipfile.ZipFile(
                os.path.join(self.path, f"part{p}.npz")
            )
        return self._zips[p]

    def part_members(self, p: int) -> List[str]:
        return [n[:-4] for n in self._zip(p).namelist() if n.endswith(".npy")]

    def sim_arrays(self, p: int) -> Dict[str, np.ndarray]:
        """The partition's ``sim_*`` runtime arrays (whole — they are
        O(n_p), not O(m_p))."""
        zf = self._zip(p)
        out = {}
        for name in self.part_members(p):
            if name.startswith("sim_"):
                out[name[4:]] = _Member(zf, name + ".npy").read_all()
        return out

    def iter_rows(
        self, p: int, chunk_rows: int = DEFAULT_CHUNK_ROWS
    ) -> Iterator[RowChunk]:
        """Stream partition ``p`` as :class:`RowChunk` blocks."""
        zf = self._zip(p)
        chunk_rows = max(1, int(chunk_rows))
        row_ptr = _Member(zf, "row_ptr.npy").read_all().astype(np.int64)
        n_p = len(row_ptr) - 1
        rows_m = {a: _Member(zf, a + ".npy") for a in _ROW_ARRAYS}
        edge_m = {a: _Member(zf, a + ".npy") for a in _EDGE_ARRAYS}
        for r0 in range(0, max(n_p, 1), chunk_rows):
            r1 = min(r0 + chunk_rows, n_p)
            if r1 <= r0:
                break
            e0, e1 = int(row_ptr[r0]), int(row_ptr[r1])
            yield RowChunk(
                part_id=p,
                row0=r0,
                e0=e0,
                row_ptr=row_ptr[r0 : r1 + 1] - e0,
                col_idx=edge_m["col_idx"].read_rows(e0, e1),
                edge_model=edge_m["edge_model"].read_rows(e0, e1),
                edge_state=edge_m["edge_state"].read_rows(e0, e1),
                vtx_model=rows_m["vtx_model"].read_rows(r0, r1),
                vtx_state=rows_m["vtx_state"].read_rows(r0, r1),
                coords=rows_m["coords"].read_rows(r0, r1),
                global_ids=rows_m["global_ids"].read_rows(r0, r1),
            )

    def part_shapes(self, p: int) -> Dict[str, Tuple[int, ...]]:
        zf = self._zip(p)
        return {
            name: tuple(_Member(zf, name + ".npy").shape)
            for name in self.part_members(p)
        }

    def load_part(
        self, p: int
    ) -> Tuple[DCSRPartition, Dict[str, np.ndarray]]:
        """Eagerly load exactly one partition (the lazy-restore unit:
        the other k-1 shards are never opened)."""
        if self.verify and p not in self._verified:
            check_shard_crc(self.path, p, self.manifest)
            self._verified.add(p)
        z = np.load(os.path.join(self.path, f"part{p}.npz"))
        part = DCSRPartition(
            part_id=p, row_start=int(self.dist[p]),
            row_ptr=z["row_ptr"], col_idx=z["col_idx"],
            vtx_model=z["vtx_model"], vtx_state=z["vtx_state"],
            edge_model=z["edge_model"], edge_state=z["edge_state"],
            coords=z["coords"], global_ids=z["global_ids"],
        )
        sim = {k[4:]: z[k] for k in z.files if k.startswith("sim_")}
        return part, sim

    def assemble_part(
        self, p: int, chunk_rows: int = DEFAULT_CHUNK_ROWS
    ) -> Tuple[DCSRPartition, Dict[str, np.ndarray]]:
        """Assemble partition ``p`` from row chunks into exact-fit arrays
        (bit-identical to :meth:`load_part`)."""
        zf = self._zip(p)
        shapes = {
            name: _Member(zf, name + ".npy")
            for name in (_ROW_ARRAYS + _EDGE_ARRAYS)
        }
        dest = {
            name: np.empty(m.shape, m.dtype) for name, m in shapes.items()
        }
        row_ptr = _Member(zf, "row_ptr.npy").read_all().astype(np.int64)
        for ch in self.iter_rows(p, chunk_rows=chunk_rows):
            r0, r1 = ch.row0, ch.row0 + ch.rows
            e0, e1 = ch.e0, ch.e0 + len(ch.col_idx)
            for name in _ROW_ARRAYS:
                dest[name][r0:r1] = getattr(ch, name)
            for name in _EDGE_ARRAYS:
                dest[name][e0:e1] = getattr(ch, name)
        part = DCSRPartition(
            part_id=p, row_start=int(self.dist[p]),
            row_ptr=row_ptr, **dest,
        )
        return part, self.sim_arrays(p)


def open_snapshot(path: str, verify: bool = True) -> SnapshotReader:
    """Open a dCSR snapshot directory for chunked streaming reads."""
    return SnapshotReader(path, verify=verify)


def load_binary_streamed(
    path: str, verify: bool = True, *, chunk_rows: int = DEFAULT_CHUNK_ROWS
) -> Tuple[DCSRNetwork, Dict[int, Dict[str, np.ndarray]], int]:
    """Streamed drop-in for ``io.dcsr_binary.load_binary`` (native k)."""
    with open_snapshot(path, verify=verify) as r:
        parts: List[DCSRPartition] = []
        sim_state: Dict[int, Dict[str, np.ndarray]] = {}
        for p in range(r.k):
            part, sim = r.assemble_part(p, chunk_rows=chunk_rows)
            parts.append(part)
            if sim:
                sim_state[p] = sim
        net = DCSRNetwork(
            dist=r.dist, parts=parts, registry=r.registry, meta=r.meta
        )
        net.validate()
        return net, sim_state, r.t_now


def load_merged_streamed(
    path: str, verify: bool = True, *, chunk_rows: int = DEFAULT_CHUNK_ROWS
) -> Tuple[DCSRNetwork, Dict[int, Dict[str, np.ndarray]], int]:
    """Stream a k-way snapshot directly into its k=1 merge.

    Bit-identical to ``merge_to_single(load_binary(path)[0])`` — see the
    module docstring — but never materializes the per-partition network
    or the COO expansion ``repartition`` would build.
    """
    with open_snapshot(path, verify=verify) as r:
        n, m = r.n, r.m
        max_sv = r.registry.max_vertex_state
        max_se = r.registry.max_edge_state
        row_ptr = np.zeros(n + 1, np.int64)
        col_idx = np.empty(m, np.int64)
        edge_model = np.empty(m, np.int32)
        edge_state = np.empty((m, max_se), np.float32)
        vtx_model = np.empty(n, np.int32)
        vtx_state = np.empty((n, max_sv), np.float32)
        coords = np.empty((n, 3), np.float32)
        global_ids = np.empty(n, np.int64)
        sim_parts: List[Dict[str, np.ndarray]] = []
        r_off = 0
        e_off = 0
        for p in range(r.k):
            part_edges = 0
            for ch in r.iter_rows(p, chunk_rows=chunk_rows):
                r0 = r_off + ch.row0
                r1 = r0 + ch.rows
                e0 = e_off + ch.e0
                e1 = e0 + len(ch.col_idx)
                row_ptr[r0 + 1 : r1 + 1] = ch.row_ptr[1:] + e0
                col_idx[e0:e1] = ch.col_idx
                edge_model[e0:e1] = ch.edge_model
                edge_state[e0:e1] = ch.edge_state
                vtx_model[r0:r1] = ch.vtx_model
                vtx_state[r0:r1] = ch.vtx_state
                coords[r0:r1] = ch.coords
                global_ids[r0:r1] = ch.global_ids
                part_edges = ch.e0 + len(ch.col_idx)
            sim_parts.append(r.sim_arrays(p))
            r_off += int(r.dist[p + 1] - r.dist[p])
            e_off += part_edges
        part = DCSRPartition(
            part_id=0, row_start=0, row_ptr=row_ptr, col_idx=col_idx,
            vtx_model=vtx_model, vtx_state=vtx_state,
            edge_model=edge_model, edge_state=edge_state,
            coords=coords, global_ids=global_ids,
        )
        net = DCSRNetwork(
            dist=np.asarray([0, n], np.int64), parts=[part],
            registry=r.registry, meta=r.meta,
        )
        net.validate()
        sim_state: Dict[int, Dict[str, np.ndarray]] = {}
        keys = set().union(*[set(s) for s in sim_parts]) if sim_parts else set()
        if keys:
            merged: Dict[str, np.ndarray] = {}
            for key in sorted(keys):
                vals = [s[key] for s in sim_parts if key in s]
                merged[key] = np.concatenate(vals, axis=-1)
            sim_state[0] = merged
        return net, sim_state, r.t_now


def make_streaming_loader(k: Optional[int] = None,
                          chunk_rows: int = DEFAULT_CHUNK_ROWS):
    """A ``loader=`` callable for ``io.dcsr_binary.load_latest_valid``:
    merged assembly when ``k == 1``, native-k streaming otherwise."""

    def loader(d, verify=True):
        if k == 1:
            return load_merged_streamed(d, verify=verify, chunk_rows=chunk_rows)
        return load_binary_streamed(d, verify=verify, chunk_rows=chunk_rows)

    return loader
