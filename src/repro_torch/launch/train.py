"""Training launcher of the LM substrate, the counterpart of
``repro/launch/train.py`` (and of ``examples/train_lm.py``).

    # on the card (the default); --device cpu runs on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 100 --reduced --ckpt /tmp/ck

Fault tolerance as the reference's: resume from the newest valid checkpoint
(corrupt and torn steps skipped), async checkpoint writes, and a final save
on SIGTERM (preemption).  The checkpoints hold the reference launcher's
tree, ``dict(params=..., opt_state=dict(m, v, count))`` in its stacked
layout (``convert.lm_train_tree``), so a checkpoint of either package's
launcher resumes in the other.

Under ``torch.distributed`` (a process group initialized by the caller)
each process computes its shard of the global batch, ``host_batch(n_hosts
= world size, host_id = rank)``, as the reference shards by
``jax.process_count()`` / ``process_index()``; as there, the processes
exchange no gradients (ROADMAP F12).
"""
import argparse
import signal
import sys

import torch

from .. import convert
from ..configs import get_config
from ..io import CheckpointManager
from ..kernels.dispatch import resolve_device
from ..models import build_model, lm_param_leaves
from ..train import AdamW, DataConfig, batch_iterator, cosine_schedule, fit


def data_shard():
    """``(n_hosts, host_id)``: the world size and rank of an initialized
    process group, else ``(1, 0)``."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--opt8bit", action="store_true")
    ap.add_argument("--reduced", action="store_true", help="reduced config (CPU-scale)")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="where to run: the card unless given (cpu: the CPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    model = build_model(cfg, device=dev)
    opt = AdamW(lr=cosine_schedule(args.lr, warmup=min(50, args.steps // 10 + 1),
                                   total=args.steps),
                quantize_moments=args.opt8bit)
    n_hosts, host_id = data_shard()
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.global_batch, n_hosts=n_hosts, host_id=host_id)

    cm = None
    opt_state = opt.init(lm_param_leaves(cfg, model))
    start = 0
    if args.ckpt:
        cm = CheckpointManager(args.ckpt)
        try:
            like = convert.lm_train_tree(cfg, model, opt_state, like=True)
            tree, start = cm.restore_latest_valid(like=like)
            model.load_state_dict(convert.lm_params_from_arrays(cfg, tree["params"]))
            opt_state = convert.lm_opt_state_from_arrays(cfg, model, tree["opt_state"])
            print(f"[train] resumed from step {start}", flush=True)
        except FileNotFoundError:
            print("[train] fresh start", flush=True)

    stop = {"now": False}

    def on_term(sig, frame):  # preemption: finish the step, save, exit
        stop["now"] = True

    signal.signal(signal.SIGTERM, on_term)

    def log_fn(msg):
        print(f"[train] {msg}", flush=True)

    def guarded_iter():
        for step, batch in batch_iterator(dc, start_step=start):
            if stop["now"]:
                log_fn(f"SIGTERM: checkpointing at step {step} and exiting")
                if cm is not None:
                    # the model and the optimizer state are updated in place:
                    # this is the state after step - 1 (ROADMAP F14)
                    cm.save(step, convert.lm_train_tree(cfg, model, opt_state), wait=True)
                sys.exit(0)
            yield step, batch

    _, opt_state, _ = fit(
        model, cfg, opt, guarded_iter(), steps=args.steps, opt_state=opt_state,
        ckpt_manager=cm, ckpt_every=args.ckpt_every, log_fn=log_fn,
        grad_accum=args.grad_accum,
    )
    if cm is not None:
        cm.save(args.steps, convert.lm_train_tree(cfg, model, opt_state), wait=True)
        cm.close()
    log_fn("done")


if __name__ == "__main__":
    main()
