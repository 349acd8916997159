"""Partition-based tensor checkpoints for training state, atomic snapshot
directories and the step-directory scan; the counterpart of
``repro/io/checkpoint.py``.

The tensor checkpoints keep the reference's on-disk layout byte for byte:

  * ``step_XXXXXXXX/leaf<i>_s<j>.npy``, one file per shard of each leaf
    (one shard a leaf on one card), written with ``np.save``;
  * ``manifest.json`` with the step and, per leaf in jax's flatten order
    (dict keys sorted, list and tuple entries in order), its ``name`` in
    jax's ``keystr`` form (``['params']['emb']['embed']``, ``[0]`` for a
    sequence entry), ``shape``, ``dtype`` and each shard's ``file``,
    ``crc`` (CRC32 of the file's bytes) and ``index`` (start/stop per dim).

A tree is nested dicts, lists and tuples whose leaves are numpy arrays,
torch tensors (on any device; copied to the host when saved) or numpy
scalars.  Fault tolerance as in the reference: CRC32 per shard, the
atomic directory swap, an async background writer with backpressure,
retention of the last ``max_to_keep`` steps, and ``restore_latest_valid``,
which walks back past corrupt, torn and partial steps.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import zlib
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .async_writer import AsyncWriter
from .durability import fsync_dir, write_bytes_verified
from .hooks import fault_point


@contextlib.contextmanager
def atomic_dir(final: str) -> Iterator[str]:
    """Write a directory atomically: yields a ``<final>.tmp`` staging dir,
    then swaps it into place via rename — a crash mid-write never leaves a
    partially-written ``final``, and at every instant a complete snapshot
    exists on disk (the previous one is renamed aside to ``<final>.old``
    before the swap, never deleted first; stale ``.tmp``/``.old`` dirs from
    an earlier crash are cleared on the next write).

    A crash *between* the two renames of the swap leaves only
    ``<final>.old`` holding the complete previous snapshot.  The next
    write through here finishes the interrupted swap (``.old`` → final)
    before clearing stale dirs, and the restore walkers
    (``load_latest_valid``, ``CheckpointManager.restore_latest_valid``)
    fall back to ``.old`` themselves — so the docstring's guarantee holds
    at restore time too, not just on the writer's happy path.  Shared by
    the tensor checkpoints here and the dCSR snapshot writer
    (io/dcsr_binary, snn/session)."""
    tmp = final + ".tmp"
    old = final + ".old"
    if os.path.exists(old) and not os.path.exists(final):
        # a crash between the two swap renames left .old as the only
        # complete snapshot: finish that swap instead of deleting it
        os.replace(old, final)
    for stale in (tmp, old):
        if os.path.exists(stale):
            shutil.rmtree(stale)
    os.makedirs(tmp)
    yield tmp
    parent = os.path.dirname(os.path.abspath(final)) or "."
    fsync_dir(tmp)  # staged entries durable before any rename
    fault_point("atomic_dir:pre_swap", final)
    if os.path.exists(final):
        os.replace(final, old)  # atomic aside, not rmtree: crash-safe
        fault_point("atomic_dir:between_renames", final)
        os.replace(tmp, final)
        fault_point("atomic_dir:after_swap", final)
        # make both renames durable before the only other complete copy
        # (.old) disappears — a power cut here must not lose the swap
        fsync_dir(parent)
        shutil.rmtree(old)
    else:
        os.replace(tmp, final)
        fault_point("atomic_dir:after_swap", final)
        fsync_dir(parent)


def step_candidates(root: str) -> List[Tuple[int, bool, str]]:
    """``(step, is_old, dir)`` for every ``step_XXXXXXXX[.old]`` dir under
    ``root`` holding a manifest — the one directory scan shared by the
    tensor-checkpoint and dCSR-snapshot restore walkers (``.old`` entries
    are torn-swap survivors, see :func:`atomic_dir`)."""
    out: List[Tuple[int, bool, str]] = []
    if not os.path.isdir(root):
        return out
    for fn in os.listdir(root):
        m = re.fullmatch(r"step_(\d+)(\.old)?", fn)
        if m and os.path.exists(os.path.join(root, fn, "manifest.json")):
            out.append(
                (int(m.group(1)), bool(m.group(2)), os.path.join(root, fn))
            )
    return out


# -- trees in jax's flatten order ---------------------------------------------

def keystr(path) -> str:
    """jax's ``keystr`` of a key path: ``['key']`` for a dict key, ``[i]``
    for a list or tuple index."""
    return "".join(f"[{k!r}]" for k in path)


def tree_flatten_with_path(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs in jax's flatten order: dict keys sorted, list
    and tuple entries in order; anything else is a leaf."""
    if isinstance(tree, Mapping):
        out = []
        for k in sorted(tree):
            out += tree_flatten_with_path(tree[k], path + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += tree_flatten_with_path(v, path + (i,))
        return out
    return [(path, tree)]


def tree_unflatten(like, leaves: List[Any]):
    """``leaves`` (in flatten order) in the structure of ``like``, whose own
    leaves are ignored."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, Mapping):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)([build(v) for v in node])
        leaf = next(it, it)
        if leaf is it:
            raise ValueError("fewer leaves than the structure holds")
        return leaf

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def host_array(leaf) -> np.ndarray:
    """A leaf as the numpy array ``np.save`` writes.  A torch tensor is
    copied to the host, on the CPU too: a tensor's values change in place
    (an optimizer step), where the reference's jax arrays never do, and a
    view would let an async write serialize later values.  A numpy leaf is
    taken as it is, as the reference takes it.  bf16 has no numpy dtype
    here; the reference's manager writes such leaves as raw two-byte voids
    it cannot read back (ROADMAP F13), so the port refuses them."""
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("a bf16 leaf: the reference's checkpoints cannot restore one "
                            "(ROADMAP F13); save it as float32")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _crc_bytes(b: bytes) -> int:
    return zlib.crc32(b)


class CheckpointManager:
    """Tensor checkpoints under ``root``, one ``step_XXXXXXXX`` directory a
    step (the reference's ``CheckpointManager``)."""

    def __init__(self, root: str, max_to_keep: int = 3, async_write: bool = True,
                 max_pending: int = 8):
        """``max_pending`` bounds the async write queue: each queued save
        holds a full host copy of the tree, so when the disk falls behind
        the save cadence, ``save`` blocks (backpressure) instead of
        accumulating snapshots until the host runs out of memory.  0 =
        unbounded."""
        self.root = root
        self.max_to_keep = max_to_keep
        self.async_write = async_write
        os.makedirs(root, exist_ok=True)
        self._writer: Optional[AsyncWriter] = (
            AsyncWriter(name="tensor-ckpt-writer", max_pending=max_pending)
            if async_write else None
        )

    # ---------------------------------------------------------------- save
    def save(self, step: int, tree: Any, wait: bool = False) -> str:
        """Snapshot to the host now (the caller's stall: each tensor's
        copy to the host, see :func:`host_array`); write in the background
        (or inline).  A numpy leaf is queued as it is: the caller leaves it
        unchanged until the write lands (``wait``).

        On an async manager ``wait=True`` still routes through the queue
        (then drains it), so earlier queued steps always land before this
        one and retention sees them in order."""
        flat = tree_flatten_with_path(tree)
        names = [keystr(path) for path, _ in flat]
        snap = []
        for _, leaf in flat:
            a = host_array(leaf)
            snap.append((tuple(a.shape), str(a.dtype), [(tuple((None, None) for _ in a.shape), a)]))
        job = (step, names, snap)
        if self._writer is not None:
            self._writer.submit(self._write, job,
                                context=dict(step=step, path=self.step_dir(step)))
            if wait:
                self._writer.wait()
        else:
            self._write(job)
        return self.step_dir(step)

    def _write(self, job):
        step, names, snap = job
        with atomic_dir(self.step_dir(step)) as tmp:
            manifest: Dict[str, Any] = dict(step=step, leaves=[])
            for i, (name, (shape, dtype, shards)) in enumerate(zip(names, snap)):
                entry = dict(name=name, shape=list(shape), dtype=dtype, shards=[])
                for j, (index, data) in enumerate(shards):
                    fn = f"leaf{i}_s{j}.npy"
                    buf = io.BytesIO()
                    np.save(buf, data)
                    crc = write_bytes_verified(os.path.join(tmp, fn), buf.getvalue(),
                                               "shard_write")
                    entry["shards"].append(dict(
                        file=fn, crc=crc,
                        # dist-style offsets: start/stop per dim
                        index=[[0 if a is None else a, shape[d] if b is None else b]
                               for d, (a, b) in enumerate(index)] if shape else [],
                    ))
                manifest["leaves"].append(entry)
            write_bytes_verified(os.path.join(tmp, "manifest.json"),
                                 json.dumps(manifest).encode(), "manifest_write")
        self._gc()

    # ------------------------------------------------------------- restore
    def restore(self, step: Optional[int] = None, like: Any = None, device=None,
                verify: bool = True) -> Tuple[Any, int]:
        """``(tree, step)``: the leaves as tensors on ``device`` (the CPU
        when None), in ``like``'s structure (its leaves are ignored), or
        the flat list in the manifest's order without one."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self._resolve_step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            man = json.load(f)
        arrays = []
        for entry in man["leaves"]:
            out = np.empty(tuple(entry["shape"]), dtype=entry["dtype"])
            for sh in entry["shards"]:
                full = os.path.join(d, sh["file"])
                fault_point("shard_read", full)
                with open(full, "rb") as f:
                    raw = f.read()
                if verify and _crc_bytes(raw) != sh["crc"]:
                    raise IOError(f"corrupt shard {sh['file']} in step {step}")
                out[tuple(slice(a, b) for a, b in sh["index"])] = np.load(io.BytesIO(raw))
            t = torch.from_numpy(out)
            arrays.append(t.to(device) if device is not None else t)
        return (tree_unflatten(like, arrays) if like is not None else arrays), step

    def restore_latest_valid(self, like: Any = None, device=None):
        """Walk steps newest-first, skipping corrupt and incomplete ones
        (node failure mid-write, bit rot): the fault-tolerant restart
        entry."""
        for step in sorted(self.all_steps(), reverse=True):
            try:
                return self.restore(step, like=like, device=device, verify=True)
            except (IOError, OSError, json.JSONDecodeError, ValueError):
                continue
        raise FileNotFoundError(f"no valid checkpoint under {self.root}")

    # ------------------------------------------------------------- helpers
    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def _resolve_step_dir(self, step: int) -> str:
        """The step's readable directory: the final dir, or its ``.old``
        sibling when a crash between atomic_dir's two swap renames left
        only that (the torn-swap window)."""
        d = self.step_dir(step)
        if os.path.exists(os.path.join(d, "manifest.json")):
            return d
        old = d + ".old"
        if os.path.exists(os.path.join(old, "manifest.json")):
            return old
        return d

    def all_steps(self) -> List[int]:
        return sorted({s for s, _, _ in step_candidates(self.root)})

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self):
        """Block until queued writes land; re-raise background errors."""
        if self._writer is not None:
            self._writer.wait()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.max_to_keep]:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)
            shutil.rmtree(self.step_dir(s) + ".old", ignore_errors=True)

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None
