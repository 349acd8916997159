"""Carry networks and step state across from the reference's arrays.

Plain functions on numpy arrays (never on objects of the JAX package), so
one identical network and one identical mid-run state can be fed to both
packages:

  * :func:`network_from_arrays` builds the port's ``DCSRNetwork`` from the
    reference's partition arrays, registry entries and meta;
  * :func:`carry_from_arrays` builds the port's step carry from the
    reference ``Simulator``'s carry, or the list of per-partition carries
    of the port's ``DistSimulator`` from the reference ``DistSimulator``'s
    stacked ``(k, ...)`` carry.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

from .core.dcsr import DCSRNetwork, DCSRPartition
from .core.state import ModelRegistry

_PART_KEYS = (
    "row_ptr", "col_idx", "vtx_model", "vtx_state", "edge_model",
    "edge_state", "coords", "global_ids",
)


def network_from_arrays(
    *,
    parts: Sequence[Mapping[str, object]],
    registry_entries: Sequence[Tuple[str, str, int, Dict[str, float]]],
    var_names: Mapping[str, Tuple[str, ...]],
    meta: Mapping[str, float],
) -> DCSRNetwork:
    """``parts[p]`` holds partition p's ``row_start`` and the arrays named in
    ``_PART_KEYS``; ``registry_entries`` is ``ModelRegistry.to_entries()``
    and ``var_names`` maps each model name to its state-variable names.
    The arrays are copied, so later changes on either side stay there."""
    registry = ModelRegistry.from_entries(registry_entries, dict(var_names))
    out = []
    for p, arrs in enumerate(parts):
        out.append(DCSRPartition(
            part_id=p,
            row_start=int(arrs["row_start"]),
            **{k: np.array(arrs[k], copy=True) for k in _PART_KEYS},
        ))
    dist = np.concatenate(
        [[0], np.cumsum([part.n for part in out])]
    ).astype(np.int64)
    net = DCSRNetwork(dist=dist, parts=out, registry=registry, meta=dict(meta))
    net.validate()
    return net


def carry_from_arrays(
    *,
    t: int,
    vtx_state: np.ndarray,
    ring: np.ndarray,
    hist: np.ndarray,
    weights: Sequence[np.ndarray],
    tr_plus: np.ndarray,
    tr_minus: np.ndarray,
    device,
) -> Union[Dict, List[Dict]]:
    """The port's step carry on ``device`` from the reference carry's
    arrays (``t`` as a host int, made the carry's 0-d int64 tensor; the
    tensors in the reference's dtypes).

    A stacked carry of the reference ``DistSimulator`` (``vtx_state`` of
    shape ``(k, n_p, S)``, every other array with the same leading
    partition axis) gives the list of k per-partition carries that the
    port's ``DistSimulator`` runs; ``device`` is then one device for all
    partitions or a sequence of k."""
    def put(a, dtype, dev):
        return torch.as_tensor(np.array(a, copy=True), dtype=dtype, device=dev)

    def one(p, dev):
        pick = (lambda a: np.asarray(a)) if p is None else (lambda a: np.asarray(a)[p])
        return dict(
            t=torch.tensor(int(t), dtype=torch.int64, device=dev),
            vtx_state=put(pick(vtx_state), torch.float32, dev),
            ring=put(pick(ring), torch.float32, dev),
            hist=put(pick(hist), torch.uint8, dev),
            weights=tuple(put(pick(w), torch.float32, dev) for w in weights),
            tr_plus=put(pick(tr_plus), torch.float32, dev),
            tr_minus=put(pick(tr_minus), torch.float32, dev),
        )

    if np.ndim(vtx_state) == 2:
        return one(None, device)
    k = np.shape(vtx_state)[0]
    devices = [device] * k if isinstance(device, (str, torch.device)) else list(device)
    if len(devices) != k:
        raise ValueError(f"{len(devices)} devices for a carry of {k} partitions")
    return [one(p, dev) for p, dev in enumerate(devices)]
