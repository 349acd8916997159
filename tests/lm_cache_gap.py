"""The bf16 gap between the cache path and a cache-free forward, in the
reference and in the port, on the CPU: an arch at its published widths
with its depth cut, both packages on the reference's params (converted by
``convert.lm_params_from_arrays``), a prompt prefilled into the cache and
then one decode step per further token (teacher-forced, random tokens
drawn from a seed); the last step's logits against a cache-free forward
over the whole sequence, as ``max |delta| / max |logits|``.

It reads the witness for ``chip_smoke.py``'s ``LM_CACHE_TOL``, which
holds the port's gap on the card at full depth.  Not collected by pytest:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/lm_cache_gap.py \\
        --arch xlstm-350m --layers 2 4 8 12
"""
import argparse
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import build_model


def _gap(last, full):
    last, full = np.asarray(last, np.float32), np.asarray(full, np.float32)
    return float(np.abs(last - full).max() / np.abs(full).max())


def gaps(name, n_layers, batch, prompt, new, seed):
    """``(reference's gap, port's gap, port against reference on the
    cache-free forward)``, each of max |logits|."""
    jcfg = dataclasses.replace(jget(name), n_layers=n_layers)
    cfg = dataclasses.replace(get_config(name), n_layers=n_layers)
    jm = jbuild(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(convert.lm_params_from_arrays(cfg, jax.tree.map(np.asarray, params)))
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, prompt + new))
    toks = toks.astype(np.int32)
    total = prompt + new

    prefill = jax.jit(lambda p, t, c: jm.apply(p, t, cache=c))
    step = jax.jit(lambda p, t, c, pos: jm.apply(p, t, cache=c, cache_pos=pos))
    forward = jax.jit(lambda p, t: jm.apply(p, t, logits_slice=1))
    _, jc, _ = prefill(params, jnp.asarray(toks[:, :prompt]), jm.init_cache(batch, total))
    for i in range(prompt, total):
        jl, jc, _ = step(params, jnp.asarray(toks[:, i:i + 1]), jc, jnp.asarray(i, jnp.int32))
    jf = forward(params, jnp.asarray(toks))[0]

    with torch.no_grad():
        tc = model.init_cache(batch, total)
        model(torch.from_numpy(toks[:, :prompt]), cache=tc)
        for i in range(prompt, total):
            tl, tc, _ = model(torch.from_numpy(toks[:, i:i + 1]), cache=tc,
                              cache_pos=torch.tensor(i, dtype=torch.int32))
        tf = model(torch.from_numpy(toks), logits_slice=1)[0]
    tl, tf = tl[:, -1].float().numpy(), tf[:, -1].float().numpy()
    jl, jf = np.asarray(jl[:, -1], np.float32), np.asarray(jf[:, -1], np.float32)
    return _gap(jl, jf), _gap(tl, tf), _gap(tf, jf)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--new", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    print(f"{args.arch}: d {cfg.d_model}, head dim {cfg.hd}, params {cfg.param_dtype}, compute "
          f"{cfg.compute_dtype}; batch {args.batch}, prompt {args.prompt}, {args.new} decode "
          f"steps; max |delta| / max |logits| of the last step against the cache-free forward")
    for n in args.layers:
        t0 = time.perf_counter()
        ref, port, cross = gaps(args.arch, n, args.batch, args.prompt, args.new, args.seed)
        print(f"{n} layers: reference {ref:.3e}, port {port:.3e}; port against reference "
              f"(cache-free forward) {cross:.3e} ({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
