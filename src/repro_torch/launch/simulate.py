"""SNN simulation launcher on the port's ``Session``: build (or resume) a
dCSR network, partition it, simulate with periodic atomic snapshots, and
resume past corrupt checkpoints; ``--supervised`` runs the self-healing
loop.  A port of ``repro.launch.simulate``.

    # on the card (the default); --device cpu runs the plain torch versions
    PYTHONPATH=src python -m repro_torch.launch.simulate --scale 0.01 --k 4 \\
        --steps 500 --snapshot-dir /tmp/mc --snapshot-every 200

``--distributed`` runs the k partitions on the spmd engine, spread over the
visible cards (partition p on card ``p % cards``: all of them on one card
when there is one); without it a k > 1 net runs merged, as one partition.
"""
import argparse
import os

import torch

from ..core import block_partition, hash_partition, rcb_partition, voxel_partition
from ..io import snapshot_steps
from ..snn import Session, SimConfig, microcircuit, to_dcsr
from ..snn.monitors import summary
from ..snn.supervisor import HealthConfig, RetryPolicy

PARTITIONERS = dict(
    block=lambda net, k: block_partition(net.n, k),
    hash=lambda net, k: hash_partition(net.n, k),
    voxel=lambda net, k: voxel_partition(net.coords, k),
    rcb=lambda net, k: rcb_partition(net.coords, k),
)


def placement(device, k: int, distributed: bool) -> dict:
    """``Session`` keywords placing the run: with ``distributed``, one
    device per partition (``device`` repeated, or the visible cards in
    turn); otherwise the one ``device`` (None: the card)."""
    if not distributed:
        return dict(device=device)
    if device is not None:
        return dict(devices=[device] * k)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu to run the plain "
            "torch versions on the CPU"
        )
    cards = torch.cuda.device_count()
    return dict(devices=[f"cuda:{p % cards}" for p in range(k)])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--k", type=int, default=1)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--partitioner", default="rcb", choices=sorted(PARTITIONERS))
    ap.add_argument("--exchange", default="dense", choices=["dense", "index"])
    ap.add_argument("--snapshot-dir", default=None)
    ap.add_argument("--snapshot-every", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where to run: the card unless given (cpu: the plain "
                         "torch versions)")
    ap.add_argument("--distributed", action="store_true",
                    help="the spmd engine, one partition a device (needs a "
                         "uniform net, built so with this flag)")
    ap.add_argument("--supervised", action="store_true",
                    help="self-healing run loop: per-chunk health checks,"
                         " rollback to the newest valid checkpoint, "
                         "corrupt-shard quarantine (needs --snapshot-dir "
                         "and --snapshot-every)")
    ap.add_argument("--max-rate", type=float, default=0.8,
                    help="supervised spike-storm ceiling (spikes/neuron/step)")
    ap.add_argument("--max-rollbacks", type=int, default=3,
                    help="supervised consecutive-rollback budget")
    args = ap.parse_args(argv)
    if args.supervised and not (args.snapshot_dir and args.snapshot_every):
        ap.error("--supervised requires --snapshot-dir and "
                 "--snapshot-every (checkpoints are the rollback "
                 "substrate)")

    cfg = SimConfig(exchange=args.exchange)
    engine = "spmd" if args.distributed else "auto"
    if args.snapshot_dir and (
        os.path.exists(os.path.join(args.snapshot_dir, "manifest.json"))
        # torn atomic swap: only <dir>.old survived; restorable, and a
        # fresh start here would overwrite (and delete) it
        or os.path.exists(os.path.join(args.snapshot_dir + ".old", "manifest.json"))
        or snapshot_steps(args.snapshot_dir)
    ):
        # fault-tolerant resume: walks newest-first past corrupt steps; the
        # spmd engine places --k partitions (repartitioning a snapshot of
        # another k)
        ses = Session.restore(
            args.snapshot_dir, cfg=cfg, engine=engine,
            k=args.k if args.distributed else None,
            **placement(args.device, args.k, args.distributed),
        )
        print(f"[simulate] resumed at t={ses.t} from {args.snapshot_dir}")
    else:
        net = microcircuit(scale=args.scale, seed=0)
        asn = PARTITIONERS[args.partitioner](net, args.k)
        d = to_dcsr(net, assignment=asn, uniform=args.distributed)
        ses = Session(d, cfg, engine=engine, **placement(args.device, args.k, args.distributed))
    print(f"[simulate] {ses.describe()}")

    every = args.snapshot_every or args.steps
    if args.supervised:
        res = ses.run_supervised(
            args.steps,
            checkpoint_every=every,
            checkpoint_dir=args.snapshot_dir,
            health=HealthConfig(max_rate=args.max_rate),
            retry=RetryPolicy(max_rollbacks=args.max_rollbacks),
        )
        print(f"[simulate] t={ses.t} {summary(res, ses.n, ses.dt)}")
        print(f"[simulate] supervised: rollbacks={res.rollbacks} "
              f"steps_lost={res.steps_lost} events={len(res.events)}")
        for ev in res.events:
            print(f"[simulate]   {ev.kind}@t={ev.t}: {ev.detail}")
        ses.close()
        return
    done = 0
    while done < args.steps:
        chunk = min(every, args.steps - done)
        res = ses.run(chunk, chunk_size=chunk)
        done += chunk
        print(f"[simulate] t={ses.t} {summary(res, ses.n, ses.dt)}")
        if args.snapshot_dir:
            ses.save(args.snapshot_dir)
            print(f"[simulate] snapshot @ t={ses.t}")


if __name__ == "__main__":
    main()
