"""Binary fast path for dCSR network + simulation state (production
checkpointing of SNN runs): a copy of the reference's
``repro/io/dcsr_binary.py`` over the port's ``core``, writing and reading
the same on-disk format 1.0 (``docs/FORMAT.md``), so a snapshot written by
either package loads in the other.

Same partition-per-file layout as the text format (each rank touches only
``part<p>.npz``), plus a JSON manifest holding the ``dist`` arrays, model
dictionary, meta, the step counter and a CRC32 per file — corruption of any
shard is detected at restore and surfaced so the caller can fall back to the
previous complete checkpoint.

The write path is split in two so it can run asynchronously
(``snn/session.py`` + ``io/async_writer.py``):

  * :func:`snapshot_network` captures everything a snapshot needs into
    host-side **copies** (a :class:`NetSnapshot`) — safe to hand to a
    background writer while the live ``net.parts`` keep mutating under
    ``sync_to_dcsr``;
  * :func:`write_snapshot` serializes a ``NetSnapshot``, writing the
    ``part<p>.npz`` shards with a thread pool (one writer per partition —
    the paper's "performed largely independently between parallel
    processes") and the manifest last.

``save_binary`` composes the two synchronously and keeps its historical
signature; sync and async checkpoints therefore share one serializer and
are bit-identical on disk.

``save_binary(..., atomic=True)`` stages the snapshot in a ``.tmp`` sibling
and swaps it in with ``os.replace`` (io/checkpoint's scheme), so a crash
mid-write never clobbers the previous complete snapshot.
:func:`load_latest_valid` is the fault-tolerant restore entry: it accepts
either a single snapshot directory or a root of ``step_XXXXXXXX`` snapshot
dirs (as written by ``Session.run(checkpoint_every=...)``) and walks
newest-first past corrupt/truncated steps, falling back to a ``.old``
sibling when a crash inside ``atomic_dir``'s swap window left only that.
"""
from __future__ import annotations

import dataclasses
import errno
import io
import json
import os
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.dcsr import DCSRNetwork, DCSRPartition
from ..core.state import ModelRegistry
from .hooks import fault_point
from .checkpoint import atomic_dir, step_candidates
from .durability import fsync_dir, write_bytes_verified

#: On-disk snapshot format version, written into every manifest as
#: ``"format_version": "<major>.<minor>"`` and checked on read.  Bump the
#: minor for backward-compatible additions (old readers may load new
#: snapshots, new fields ignored); bump the major for layout changes old
#: readers must not attempt.  The byte-level contract is documented in
#: ``docs/FORMAT.md`` — keep the two in sync.
FORMAT_VERSION = (1, 0)


def check_format_version(man: Dict, source: str = "snapshot") -> Tuple[int, int]:
    """Validate the manifest's ``format_version`` against this reader.

    A manifest without the field predates versioning and is treated as the
    current version (the 1.0 layout is exactly the historical one).  A
    newer **minor** version loads with a :class:`UserWarning` (additions
    are backward compatible by contract); a newer **major** version raises
    ``ValueError`` — the layout may have changed incompatibly and reading
    on would risk silently wrong state."""
    raw = man.get("format_version")
    if raw is None:
        return FORMAT_VERSION
    try:
        maj, mino = (int(x) for x in str(raw).split("."))
    except Exception as e:
        raise ValueError(
            f"{source}: unparseable format_version {raw!r} "
            f"(expected '<major>.<minor>')"
        ) from e
    if maj > FORMAT_VERSION[0]:
        raise ValueError(
            f"{source}: format_version {raw} is newer than this reader "
            f"(supports up to major {FORMAT_VERSION[0]}); refusing to "
            "guess at an incompatible layout"
        )
    if maj == FORMAT_VERSION[0] and mino > FORMAT_VERSION[1]:
        import warnings

        warnings.warn(
            f"{source}: format_version {raw} is a newer minor revision "
            f"than this reader ({FORMAT_VERSION[0]}.{FORMAT_VERSION[1]}); "
            "loading anyway — unknown additive fields will be ignored",
            UserWarning, stacklevel=2,
        )
    return maj, mino


def _crc(path: str) -> int:
    c = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return c
            c = zlib.crc32(chunk, c)


class ShardWriteError(OSError):
    """A shard write that still failed after the write-level retries;
    carries the partition id so queue-level error context can name it."""

    def __init__(self, part_id: int, path: str, cause: BaseException):
        super().__init__(
            errno.EIO, f"shard part{part_id} failed to write: {cause}", path
        )
        self.part_id = part_id


@dataclasses.dataclass
class NetSnapshot:
    """Host-side capture of one dCSR snapshot, decoupled from the live
    network: ``parts`` maps part_id -> the arrays its ``part<p>.npz``
    shard will hold (mutable state copied; immutable topology referenced),
    ``manifest`` is everything but the per-file CRCs (computed at write
    time)."""

    parts: List[Tuple[int, Dict[str, np.ndarray]]]
    manifest: Dict


def snapshot_network(
    net: DCSRNetwork,
    sim_state: Optional[Dict[int, Dict[str, np.ndarray]]] = None,
    t_now: int = 0,
) -> NetSnapshot:
    """Capture ``net`` (+ optional per-partition runtime arrays) into a
    :class:`NetSnapshot` of host buffers.

    Arrays the engines mutate between checkpoints (``vtx_state``,
    ``edge_state`` — rewritten in place by ``sync_to_dcsr`` /
    ``scatter_weights_back`` — and the ``sim_*`` runtime arrays, which may
    be zero-copy views of device buffers) are **copied**; the topology
    arrays (row_ptr, col_idx, models, coords, global_ids) are immutable
    for the lifetime of a session and are referenced.  The result is
    race-free against continued simulation and a later ``sync_to_dcsr``.
    """
    parts: List[Tuple[int, Dict[str, np.ndarray]]] = []
    for part in net.parts:
        arrs = dict(
            row_ptr=part.row_ptr, col_idx=part.col_idx,
            vtx_model=part.vtx_model,
            vtx_state=np.array(part.vtx_state, copy=True),
            edge_model=part.edge_model,
            edge_state=np.array(part.edge_state, copy=True),
            coords=part.coords, global_ids=part.global_ids,
        )
        if sim_state and part.part_id in sim_state:
            for k, v in sim_state[part.part_id].items():
                arrs[f"sim_{k}"] = np.array(v, copy=True)
        parts.append((part.part_id, arrs))
    manifest = dict(
        format_version=f"{FORMAT_VERSION[0]}.{FORMAT_VERSION[1]}",
        k=net.k, n=net.n, m=net.m,
        dist=[int(x) for x in net.dist],
        edist=[int(x) for x in net.edist],
        meta=net.meta,
        t_now=int(t_now),
        models=[
            [n_, k_, s_, p_] for n_, k_, s_, p_ in net.registry.to_entries()
        ],
        layouts={
            s.name: list(s.state_vars)
            for s in list(net.registry.vertex_models())
            + list(net.registry.edge_models())
            if s.state_vars
        },
    )
    # procedurally built networks carry their generating RuleSpec (as a
    # JSON dict, attached by builder.procedural.build_network): embed it
    # so a corrupt shard's topology can be regenerated at restore time
    rs = getattr(net, "rule_spec", None)
    if rs is not None:
        manifest["rule_spec"] = rs
    return NetSnapshot(parts=parts, manifest=manifest)


def write_snapshot(
    snap: NetSnapshot,
    path: str,
    atomic: bool = False,
    max_workers: Optional[int] = None,
) -> None:
    """Serialize a :class:`NetSnapshot` to ``path``.

    The ``part<p>.npz`` shards are written concurrently by a thread pool
    (by default one writer per partition, capped at the host's CPU
    count); the manifest — whose presence marks the snapshot complete —
    is written last, after every shard (and its CRC) landed."""
    if atomic:
        with atomic_dir(path) as tmp:
            _write_snapshot_dir(snap, tmp, max_workers)
        return
    os.makedirs(path, exist_ok=True)
    _write_snapshot_dir(snap, path, max_workers)


def _write_part(path: str, item: Tuple[int, Dict[str, np.ndarray]]):
    part_id, arrs = item
    fn = f"part{part_id}.npz"
    full = os.path.join(path, fn)
    # serialize to memory first: the CRC is computed from the buffer the
    # verified write checks the disk against, so a torn/bit-rotted write
    # can never be recorded in the manifest as the shard's "good" CRC
    buf = io.BytesIO()
    np.savez(buf, **arrs)
    try:
        crc = write_bytes_verified(full, buf.getvalue(), "shard_write")
    except OSError as e:
        raise ShardWriteError(part_id, full, e) from e
    return fn, crc


def _write_snapshot_dir(snap: NetSnapshot, path, max_workers=None):
    if max_workers is None:
        max_workers = max(min(len(snap.parts), os.cpu_count() or 1), 1)
    if max_workers > 1 and len(snap.parts) > 1:
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            crcs = dict(
                pool.map(lambda it: _write_part(path, it), snap.parts)
            )
    else:
        crcs = dict(_write_part(path, it) for it in snap.parts)
    manifest = dict(snap.manifest, crc=crcs)
    tmp = os.path.join(path, "manifest.json.tmp")
    write_bytes_verified(tmp, json.dumps(manifest).encode(),
                         "manifest_write")
    os.replace(tmp, os.path.join(path, "manifest.json"))
    fsync_dir(path)


def save_binary(
    net: DCSRNetwork,
    path: str,
    sim_state: Optional[Dict[int, Dict[str, np.ndarray]]] = None,
    t_now: int = 0,
    atomic: bool = False,
) -> None:
    """``sim_state[p]`` may carry per-partition runtime arrays
    (ring, hist, tr_plus, tr_minus) to make restarts exact.

    ``atomic=True`` writes through a tmp dir + ``os.replace`` so ``path``
    only ever holds a complete snapshot.  This is the synchronous
    composition of :func:`snapshot_network` + :func:`write_snapshot`."""
    write_snapshot(snapshot_network(net, sim_state, t_now), path,
                   atomic=atomic)


def registry_from_manifest(man: Dict) -> ModelRegistry:
    return ModelRegistry.from_entries(
        [(m[0], m[1], m[2], m[3]) for m in man["models"]],
        var_names={k: tuple(v) for k, v in man.get("layouts", {}).items()},
    )


def check_shard_crc(path: str, p: int, man: Dict) -> str:
    """Stream-CRC shard ``p`` against the manifest; returns its path."""
    fn = os.path.join(path, f"part{p}.npz")
    fault_point("shard_read", fn)
    got = _crc(fn)
    want = man["crc"][f"part{p}.npz"]
    if got != want:
        raise IOError(
            f"checkpoint shard part{p}.npz corrupt "
            f"(crc {got:#x} != {want:#x})"
        )
    return fn


def verify_snapshot(path: str) -> Tuple[Dict, List[int]]:
    """CRC-check every shard of one snapshot dir against its manifest.

    Returns ``(manifest, bad)`` where ``bad`` lists the partition ids
    whose shard is missing or fails CRC.  Raises ``OSError`` /
    ``ValueError`` if the manifest itself is unreadable (the snapshot is
    then unusable as a whole, not per-shard recoverable)."""
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    check_format_version(man, source=path)
    bad: List[int] = []
    for p in range(int(man["k"])):
        try:
            check_shard_crc(path, p, man)
        except (OSError, KeyError):
            bad.append(p)
    return man, bad


def quarantine_shards(path: str, parts: Sequence[int]) -> List[str]:
    """Rename each ``part<p>.npz`` aside to ``part<p>.npz.quarantine``
    (the damaged bytes are kept for post-mortem, and the snapshot stops
    looking restorable to the walkers).  Returns the quarantine paths."""
    out: List[str] = []
    for p in parts:
        src = os.path.join(path, f"part{p}.npz")
        dst = src + ".quarantine"
        if os.path.exists(src):
            os.replace(src, dst)
        out.append(dst)
    fsync_dir(path)
    return out


def _stub_partition(p: int, dist: np.ndarray, max_sv: int,
                    max_se: int) -> DCSRPartition:
    """Placeholder for a shard that was not requested (lazy load): right
    row count, zero edges, zero-row state — never valid to simulate."""
    n_p = int(dist[p + 1] - dist[p])
    return DCSRPartition(
        part_id=p, row_start=int(dist[p]),
        row_ptr=np.zeros(n_p + 1, np.int64),
        col_idx=np.zeros(0, np.int64),
        vtx_model=np.zeros(0, np.int32),
        vtx_state=np.zeros((0, max_sv), np.float32),
        edge_model=np.zeros(0, np.int32),
        edge_state=np.zeros((0, max_se), np.float32),
        coords=np.zeros((0, 3), np.float32),
        global_ids=np.zeros(0, np.int64),
    )


def load_binary(
    path: str, verify: bool = True, *, parts: Optional[Sequence[int]] = None
) -> Tuple[DCSRNetwork, Dict[int, Dict[str, np.ndarray]], int]:
    """Load a snapshot directory.

    ``parts`` (lazy per-partition load) restricts deserialization to the
    listed partition ids: only those shards are opened and CRC-checked;
    the other k-1 slots hold zero-edge stub partitions and the returned
    network carries ``loaded_parts`` (a frozenset) instead of passing
    full validation.  ``parts=None`` keeps the historical eager
    behaviour (all shards, validated)."""
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    check_format_version(man, source=path)
    registry = registry_from_manifest(man)
    dist = np.asarray(man["dist"], np.int64)
    k = int(man["k"])
    if parts is None:
        want = None
    else:
        want = {int(p) for p in parts}
        bad = [p for p in want if not (0 <= p < k)]
        if bad:
            raise ValueError(f"requested partitions {bad} out of range for k={k}")
    part_list: List[DCSRPartition] = []
    sim_state: Dict[int, Dict[str, np.ndarray]] = {}
    for p in range(k):
        if want is not None and p not in want:
            part_list.append(
                _stub_partition(p, dist, registry.max_vertex_state,
                                registry.max_edge_state)
            )
            continue
        fn = os.path.join(path, f"part{p}.npz")
        if verify:
            check_shard_crc(path, p, man)
        z = np.load(fn)
        part_list.append(
            DCSRPartition(
                part_id=p, row_start=int(dist[p]),
                row_ptr=z["row_ptr"], col_idx=z["col_idx"],
                vtx_model=z["vtx_model"], vtx_state=z["vtx_state"],
                edge_model=z["edge_model"], edge_state=z["edge_state"],
                coords=z["coords"], global_ids=z["global_ids"],
            )
        )
        ss = {
            k_[4:]: z[k_] for k_ in z.files if k_.startswith("sim_")
        }
        if ss:
            sim_state[p] = ss
    net = DCSRNetwork(
        dist=dist, parts=part_list, registry=registry, meta=man["meta"]
    )
    if "rule_spec" in man:
        net.rule_spec = man["rule_spec"]
    if want is None:
        net.validate()
    else:
        net.loaded_parts = frozenset(want)  # partial: skip global validation
    return net, sim_state, int(man["t_now"])


def snapshot_steps(root: str) -> List[int]:
    """Step numbers of ``step_XXXXXXXX`` snapshot dirs under ``root`` that
    at least have a manifest (sorted ascending).  A step surviving only as
    its ``step_XXXXXXXX.old`` sibling (crash inside the atomic-swap
    window) counts too — ``load_latest_valid`` knows how to read it."""
    return sorted({s for s, _, _ in step_candidates(root)})


def _snapshot_dir_candidates(root: str) -> List[Tuple[int, str]]:
    """(step, dir) restore candidates under ``root``, newest step first;
    within a step the final dir is tried before its ``.old`` sibling (the
    torn-swap fallback)."""
    cands = step_candidates(root)
    cands.sort(key=lambda c: (-c[0], c[1]))
    return [(step, d) for step, _, d in cands]


def load_latest_valid(
    path: str, verify: bool = True, *,
    parts: Optional[Sequence[int]] = None,
    loader: Optional[Callable] = None,
) -> Tuple[DCSRNetwork, Dict[int, Dict[str, np.ndarray]], int]:
    """Fault-tolerant snapshot restore.

    ``path`` is either one snapshot dir (has ``manifest.json``) or a root
    of ``step_XXXXXXXX`` snapshot dirs; in the latter case steps are tried
    newest-first and corrupt/truncated ones (CRC mismatch, torn manifest,
    missing shard) are skipped — the dCSR analogue of
    ``CheckpointManager.restore_latest_valid``.  In both forms a snapshot
    that exists only as ``<dir>.old`` — the window where a crash hit
    ``atomic_dir`` between renaming the previous snapshot aside and
    renaming the new one in — is found and restored, so "at every instant
    a complete snapshot exists on disk" holds at restore time too.

    ``parts`` makes the walk lazy per-partition (see :func:`load_binary`);
    ``loader`` swaps the per-directory deserializer (signature
    ``loader(snapshot_dir, verify=...)``), so a streaming reader can share
    this CRC/``.old``-fallback walk.
    """
    if loader is None:
        def loader(d, verify=verify):
            return load_binary(d, verify=verify, parts=parts)
    elif parts is not None:
        raise ValueError("pass parts= or loader=, not both")
    old = os.fspath(path) + ".old"
    has_old = os.path.exists(os.path.join(old, "manifest.json"))
    if os.path.exists(os.path.join(path, "manifest.json")):
        try:
            return loader(path, verify=verify)
        except (OSError, ValueError, KeyError, zipfile.BadZipFile,
                AssertionError):
            # corrupt final with an intact .old sibling (crash after the
            # swap but before the .old cleanup, then bit rot): fall back
            # like the step-root walk does
            if has_old:
                return loader(old, verify=verify)
            raise
    cands = _snapshot_dir_candidates(os.fspath(path))
    for _step, d in cands:
        try:
            return loader(d, verify=verify)
        except (OSError, ValueError, KeyError, zipfile.BadZipFile,
                AssertionError):
            continue
    if not cands and has_old:
        # single-snapshot form, torn mid-swap: only the .old survived
        return loader(old, verify=verify)
    raise FileNotFoundError(f"no valid dCSR snapshot under {path!r}")
