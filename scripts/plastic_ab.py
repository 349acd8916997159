"""The plastic kernels and paths of two checkouts, timed in turns on one card.

    python3 scripts/plastic_ab.py ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is a checkout of this repository (say, an earlier commit unpacked
with ``git archive`` beside the working tree); each run takes a fresh
process, which imports that checkout's ``chip_smoke.py`` and package and
builds its kernels.  On the Brunel net of ``chip_smoke.py``
(``balanced_ei(n=12500, stdp=True)``, merged from its 4 uniform blocks, and
as the 4 partitions on one card) a run makes ``phase_plastic_kernels`` and
``phase_plastic_timing`` (``stdp_update``, ``fused_plastic_step``), then
``phase_k4_plastic_kernels`` and ``phase_k4_plastic_timing`` (the two
``post_exchange_plastic`` passes), and times 256 graphed steps twice (host
clock around a synchronised run, the key captured first), with the
captured graph's kernel nodes a step, of four paths: ``fused_plastic``,
the k=4 ``fused_split_plastic``, the ``unfused`` plastic engine
(``SimConfig(fused=False)``: ``spike_gather`` a bucket and the step's
``stdp_update``) and its ``[maxk]`` form (``SimConfig(max_k=64,
align_k=32)``: one ``segment_gather`` and the ``stdp_update``).  The run's own
checks (each kernel against its plain version) must pass.  Prints each
run's figures, then a table of them, and the card's name and power limit.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time
from pathlib import Path

STEPS = 256
MARK = "PLASTIC_AB "


def one(root: Path) -> dict:
    """The figures of one checkout, in this process."""
    sys.path[:0] = [str(root), str(root / "src")]
    import numpy as np
    import torch

    import chip_smoke as C

    if not torch.cuda.is_available():
        raise SystemExit("plastic_ab.py needs a CUDA card")
    card = torch.device("cuda", 0)
    pd4 = C.to_dcsr(C.balanced_ei(n=C.PLASTIC_N, stdp=True, seed=0),
                    assignment=C.block_partition(C.PLASTIC_N, C.K_PARTS), uniform=True)
    pnet = C.merge_to_single(pd4)
    params = C.lif_params(pnet)
    launches = collections.defaultdict(int)
    out = dict(root=str(root), kernels={}, graphed_us={}, kernels_a_step={})

    def graphed(tag, ses):
        sim, st0 = ses.simulator, ses.state
        sim.run(st0, STEPS)  # captures the key
        us = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.run(st0, STEPS)
            torch.cuda.synchronize()
            us.append((time.perf_counter() - t0) / STEPS * 1e6)
        out["graphed_us"][tag] = us
        out["kernels_a_step"][tag] = [C.graph_node_kinds(g.graph)["kernel"] / g.steps
                                      for g in sim._graphs.graphs.values()]

    pses = C.Session(pnet, C.SimConfig())
    pses4 = C.spmd_session(pd4, card)
    psim, pdsim = pses.simulator, pses4.simulator
    inputs, errs = C.phase_plastic_kernels(psim, params, np.random.default_rng(0))
    got = C.phase_plastic_timing(psim, params, inputs, errs, launches)
    inputs, errs = C.phase_k4_plastic_kernels(pdsim, params, np.random.default_rng(0))
    got += C.phase_k4_plastic_timing(pdsim, params, inputs, errs, launches)
    out["kernels"] = {k["name"]: k["ms"] for k in got}
    graphed("plastic", pses)
    graphed("k4p", pses4)
    graphed("unfused", C.Session(pnet, C.SimConfig(fused=False)))
    graphed("maxk", C.Session(pnet, C.SimConfig(max_k=64, align_k=32)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", type=Path)
    ap.add_argument("--one", action="store_true", help="run the first root in this process")
    args = ap.parse_args()
    if args.one:
        print(MARK + json.dumps(one(args.roots[0].resolve())), flush=True)
        return 0
    runs = []
    for root in args.roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", str(root)],
                              capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"{root}: exit code {proc.returncode}")
            return 1
        line = next(x for x in proc.stdout.splitlines() if x.startswith(MARK))
        runs.append(json.loads(line[len(MARK):]))
    names = sorted(runs[0]["kernels"])
    print("\nrun | root | " + " | ".join(f"{k} ms" for k in names))
    for i, r in enumerate(runs):
        print(f"{i + 1} | {r['root']} | "
              + " | ".join(f"{r['kernels'].get(k, float('nan')):.4f}" for k in names))
    print("\nrun | root | graphed us/step | kernels a step")
    for i, r in enumerate(runs):
        print(f"{i + 1} | {r['root']} | "
              + "; ".join(f"{tag} " + ", ".join(f"{x:.1f}" for x in us)
                          for tag, us in r["graphed_us"].items())
              + " | " + "; ".join(f"{tag} " + ", ".join(f"{x:.2f}" for x in n)
                                  for tag, n in r["kernels_a_step"].items()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
