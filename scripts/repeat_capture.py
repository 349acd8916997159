"""Repeat the k=4 plastic graphed-vs-uncaptured cases of the port's gpu
tests in one process, to measure how often a CUDA graph capture fails.

Each round runs ``test_k4_plastic_graphs_equal_the_uncaptured_loop`` of
``tests/test_torch_gpu.py`` once for each of its five field sets (overlap
off, local, double_buffer; the index exchange; the unfused engine) on one
card.  Rounds stop at ``--rounds`` or once ``--budget`` seconds have
passed.  ``--gc-threshold`` sets Python's collector thresholds first (an
eager collector runs more collections during each capture).

    python scripts/repeat_capture.py [--tree DIR] [--rounds 15] [--budget 240] \\
        [--gc-threshold 100,2,2] [--tag NAME]

``--tree`` is the root of the checkout whose ``src/`` and ``tests/`` are
run (default: this one), so two commits can be compared in one session.
Prints one JSON line: the rounds run, the failures per field set, the first
errors and the seconds taken.  Needs a CUDA card.
"""
import argparse
import gc
import json
import os
import sys
import time

FIELDS = [dict(overlap="off"), dict(overlap="local"), dict(overlap="double_buffer"),
          dict(exchange="index"), dict(fused=False)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--budget", type=float, default=240.0, help="seconds before no new round")
    ap.add_argument("--gc-threshold", default="", help="gc.set_threshold values, e.g. 100,2,2")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [os.path.join(tree, "src"), os.path.join(tree, "tests")]
    os.chdir(tree)
    if args.gc_threshold:
        gc.set_threshold(*map(int, args.gc_threshold.split(",")))
    import torch
    import test_torch_gpu as gpu_tests

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    cuda = torch.device("cuda")
    fails = [0] * len(FIELDS)
    errors = []
    t0 = time.time()
    done = 0
    while done < args.rounds and time.time() - t0 <= args.budget:
        for i, fields in enumerate(FIELDS):
            try:
                gpu_tests.test_k4_plastic_graphs_equal_the_uncaptured_loop(cuda, fields)
            except Exception as e:  # a failed case is counted, and the rounds go on
                fails[i] += 1
                errors.append(f"round {done} fields{i}: {type(e).__name__}: {str(e)[:300]}")
                torch.cuda.synchronize()
        done += 1
    print(json.dumps(dict(tag=args.tag, tree=tree, gc=gc.get_threshold(), rounds=done,
                          fails={f"fields{i}": n for i, n in enumerate(fails)},
                          seconds=round(time.time() - t0, 1), errors=errors[:10])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
