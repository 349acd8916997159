"""Elastic resharding of the port's snapshots, and the runtime-state helpers
of the k > 1 engine (counterpart of ``repro/snn/reshard.py``).

A snapshot taken at one k restores onto any other k and continues bit for
bit, because (a) the dCSR snapshot holds the network and its vertex and
edge state, (b) the runtime arrays (ring, hist, traces) are row-aligned,
so they permute with the rows, and (c) the noise is a pure function of
``(seed, t, permanent neuron id)`` on every device.

``reshard_sim_state`` needs the whole network on the host: ``repartition``
relabels rows from a global edge view.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from ..core.dcsr import DCSRNetwork, repartition

# in-flight runtime arrays of the carry (the serialization side-channel)
RUNTIME_KEYS = ("ring", "hist", "tr_plus", "tr_minus")


def reshard_sim_state(
    net: DCSRNetwork,
    sim_state: Dict[int, Dict[str, np.ndarray]],
    new_assignment: np.ndarray,
) -> Tuple[DCSRNetwork, Dict[int, Dict[str, np.ndarray]]]:
    """Repartition a (network, runtime-state) snapshot.

    ``sim_state[p][key]``, over partition p's local vertices on its last
    axis, is gathered into the new partitions through the permanent ids.
    ``new_assignment`` indexes the network's *current* global labelling."""
    glob = {
        key: np.concatenate([sim_state[p][key] for p in range(net.k)], axis=-1)
        for key in RUNTIME_KEYS
        if all(p in sim_state and key in sim_state[p] for p in range(net.k))
    }
    # permanent id -> position in the old global labelling
    perm_to_old = np.empty(net.n, dtype=np.int64)
    perm_to_old[np.concatenate([p.global_ids for p in net.parts])] = np.arange(net.n)
    new_net = repartition(net, np.asarray(new_assignment, np.int64))
    new_state = {
        p_i: {key: np.take(arr, perm_to_old[part.global_ids], axis=-1)
              for key, arr in glob.items()}
        for p_i, part in enumerate(new_net.parts)
    }
    return new_net, new_state


def stack_runtime(state: Sequence[Dict], k: int) -> Dict[int, Dict[str, np.ndarray]]:
    """Split a k > 1 carry (the port's list of per-partition carries) into
    per-partition runtime dicts on the host, keyed by partition."""
    if len(state) != k:
        raise ValueError(f"a carry of {len(state)} partitions for k={k}")
    return {
        p: {key: carry[key].cpu().numpy() for key in RUNTIME_KEYS if key in carry}
        for p, carry in enumerate(state)
    }


def concat_runtime(sim_state: Dict[int, Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Concatenate per-partition runtime arrays along the vertex axis, in
    partition order: the merged (k=1) labelling, since ``merge_to_single``
    relabels partition-major.  Used when a k > 1 snapshot is restored onto
    the single-partition engine."""
    if not sim_state:
        return {}
    parts = [sim_state[p] for p in sorted(sim_state)]
    keys = set(RUNTIME_KEYS).intersection(*(set(p) for p in parts))
    return {
        key: (parts[0][key] if len(parts) == 1
              else np.concatenate([p[key] for p in parts], axis=-1))
        for key in RUNTIME_KEYS
        if key in keys
    }
