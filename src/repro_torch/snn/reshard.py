"""Runtime-state helpers of the k > 1 engine (counterpart of the part of
``repro/snn/reshard.py`` that ``DistSimulator.runtime_state`` needs; the
elastic reshard itself comes with snapshots, ROADMAP item 6)."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

# in-flight runtime arrays of the carry (the serialization side-channel)
RUNTIME_KEYS = ("ring", "hist", "tr_plus", "tr_minus")


def stack_runtime(state: Sequence[Dict], k: int) -> Dict[int, Dict[str, np.ndarray]]:
    """Split a k > 1 carry (the port's list of per-partition carries) into
    per-partition runtime dicts on the host, keyed by partition."""
    if len(state) != k:
        raise ValueError(f"a carry of {len(state)} partitions for k={k}")
    return {
        p: {key: carry[key].cpu().numpy() for key in RUNTIME_KEYS if key in carry}
        for p, carry in enumerate(state)
    }
