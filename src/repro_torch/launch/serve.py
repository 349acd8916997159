"""Batched LM serving on the port: prefill a prompt batch, decode with the
KV cache (a ring for local attention) and the recurrent states, greedy or
sampled.  The counterpart of ``examples/serve_lm.py``; the weights, the
prompt and the stub frontends' embeddings are random, drawn from a
fixed seed.

    # on the card (the default); --device cpu runs on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
        --batch 4 --prompt-len 16 --max-new 24 [--full]

Without ``--full`` the arch runs ``reduced()``.  An enc-dec arch takes
``FRAMES`` frame embeddings for its encoder; a VLM its ``n_img_tokens``
patch embeddings, and its cache holds them too.
"""
import argparse
import time

import torch

from ..configs import ARCHS, get_config
from ..kernels.dispatch import resolve_device
from ..models import build_model
from ..train import greedy_generate

FRAMES = 16  # encoder frames of an enc-dec arch
SEED = 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--full", action="store_true", help="the published widths and depth")
    ap.add_argument("--device", default=None,
                    help="where to run: the card unless given (cpu: the CPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, generator=gen)
    build_s = time.perf_counter() - t0
    extras = None
    if cfg.encdec:
        extras = dict(frames=torch.randn((args.batch, FRAMES, cfg.d_model),
                                         generator=gen, device=dev))
    elif cfg.n_img_tokens:
        extras = dict(img_embed=torch.randn((args.batch, cfg.n_img_tokens, cfg.d_model),
                                            generator=gen, device=dev))
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
                           device=dev, dtype=torch.int32)
    t0 = time.perf_counter()
    out = greedy_generate(
        model, cfg, prompt, args.max_new, extras=extras, temperature=args.temperature,
        seed=SEED,
        cache_len=args.prompt_len + args.max_new + (cfg.n_img_tokens or 0),
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = args.batch * args.max_new
    print(f"{cfg.name} on {dev}: parameters built in {build_s:.2f} s; generated {toks} tokens "
          f"in {dt:.2f} s ({toks / dt:.1f} tok/s, prefill included)")
    print("first sequence:", out[0].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
