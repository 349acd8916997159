"""Time the port's ``to_dcsr`` of the Potjans-Diesmann microcircuit with the
edge sort ``from_edges`` uses (one stable sort of the packed key ``dst * n
+ src``, ``core/dcsr.py:edge_order``) against the ``np.lexsort`` it
replaced, in turns on one host, and check that both give the same network.

    PYTHONPATH=src python scripts/to_dcsr_sort_ab.py [--scale 1.0] [--k 4] [--seed 0] \
        [--rounds 2]

The net is ``microcircuit(scale, seed)`` partitioned as ``chip_smoke.py``
partitions it (``block_partition(n, k)``, uniform).  Runs alternate
packed and lexsort for ``--rounds`` rounds (host clock around
``to_dcsr``); the networks of the first two runs are compared array by
array.  Prints one JSON line with
the seconds of every run, the edges, the host's CPU count and torch's
thread count.  Needs no card.
"""
import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.core import block_partition
from repro_torch.core import dcsr
from repro_torch.snn.network import microcircuit, to_dcsr

ARRAYS = ("row_ptr", "col_idx", "vtx_model", "vtx_state", "edge_model", "edge_state",
          "coords", "global_ids")


def lexsort_order(nsrc, ndst, n):
    return np.lexsort((nsrc, ndst))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    net = microcircuit(scale=args.scale, seed=args.seed)
    assign = block_partition(net.n, args.k)
    packed = dcsr.edge_order
    runs = {"packed": [], "lexsort": []}
    first = {}
    for sort in ("packed", "lexsort") * args.rounds:
        dcsr.edge_order = packed if sort == "packed" else lexsort_order
        t0 = time.perf_counter()
        d = to_dcsr(net, assignment=assign, uniform=True)
        runs[sort].append(time.perf_counter() - t0)
        if sort not in first:
            first[sort] = d
        del d
    dcsr.edge_order = packed
    same = all(np.array_equal(getattr(a, key), getattr(b, key))
               for a, b in zip(first["packed"].parts, first["lexsort"].parts, strict=True)
               for key in ARRAYS)
    print(json.dumps(dict(scale=args.scale, k=args.k, n=first["packed"].n,
                          m=first["packed"].m, seconds=runs, same_network=same,
                          cpus=os.cpu_count(), torch_threads=torch.get_num_threads())))
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
