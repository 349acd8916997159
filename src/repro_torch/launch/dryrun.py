"""Production-mesh dry run: drive one step of every (architecture x input
shape x mesh) cell under a fake process group of 256 (16x16) or 512
(2x16x16) ranks, with zero allocation, and record per device what it holds
and what it does; the counterpart of ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell against 512 fake XLA devices
and reads ``memory_analysis``, ``cost_analysis`` and the post-SPMD HLO.  The
port has no compiler to ask, so it runs the step itself, as rank 0 of a
``torch.distributed`` "fake" process group (its collectives move nothing),
on tensors that have shapes, dtypes and no storage: the parameters,
optimizer state, caches and inputs are DTensors whose local shards are meta
tensors, so DTensor's propagation, the policy's redistributions and the
port's own collectives (whose meta kernels give their results' shapes) run
as they would on the mesh.  (Not ``FakeTensorMode``: under it DTensor's
redistribution costing reads a fake tensor's values with ``tolist()`` and
fails.)  It allocates nothing and measures no device, as the reference's
fake CPU devices measure none: it is no CPU fallback of the step, and no
time in its records was taken on a card.

Each record gives, per device:

  * ``param_bytes``, ``opt_bytes``, ``cache_bytes``, ``input_bytes``: the
    local shards' bytes, and ``allocated_bytes``, those of the shards that
    hold storage (0: every shard is a meta tensor);
  * ``flops_per_device`` and ``op_bytes_per_device`` (the unfused traffic)
    and the collectives by kind (``analysis.roofline.StepCounter``);
  * ``roofline`` (the H100 data sheet's peaks) and ``dominant``;
  * ``model_flops_per_device`` and ``useful_flops_ratio``;
  * ``replicated_ops``: the ops that ran replicated for want of a DTensor
    strategy (``sharding.policy.REPLICATED``).

The reference's ``xla_cost_*``, ``n_whiles``, ``max_loop_multiplier`` and
``memory`` (XLA's buffer assignment) mean nothing here and are left out.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      [--arch smollm-135m] [--shape train_4k] [--mesh single|multi|both] \\
      [--opt adamw|adamw8bit] [--out results/dryrun_torch] [--override k=v,...]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --snn [--snn-k 256] \\
      [--snn-scale 0.5] [--snn-exchange dense|index] [--snn-cap 0.25]

``--snn`` works out the SNN simulator's cell on the host (``lower_snn_cell``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode

from ..analysis.roofline import PEAKS, StepCounter, dominant_term, roofline_terms
from ..configs import ARCHS, SHAPES, cells_for, get_config
from ..sharding.policy import REPLICATED, make_policy, shard_model
from ..train.optimizer import AdamW
from ..train.serve import make_prefill_fn, make_serve_step, shard_cache
from ..train.train_loop import make_train_step, shard_batch
from .mesh import make_production_mesh
from .specs import abstract_model, input_specs, local_bytes, tensors_of


def _coerce(v: str):
    for fn in (int, float):
        try:
            return fn(v)
        except ValueError:
            pass
    if v in ("True", "False"):
        return v == "True"
    return v


def parse_overrides(s: Optional[str]) -> Dict[str, Any]:
    if not s:
        return {}
    return {kv.split("=", 1)[0]: _coerce(kv.split("=", 1)[1]) for kv in s.split(",")}


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks (this process rank 0),
    destroyed on exit.  It refuses to start over a group that exists."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the dry run makes its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def model_flops(cfg, cell) -> float:
    n_active = cfg.n_active_params()
    if cell.kind == "train":
        return 6.0 * n_active * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n_active * cell.global_batch * cell.seq_len
    return 2.0 * n_active * cell.global_batch  # one token


def lower_cell(arch: str, shape: str, *, multi_pod: bool = False, opt_name: str = "adamw",
               seq_shard: bool = True, overrides: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
    """Drive one cell's step on the fake mesh; returns its record (see the
    module's docstring).  The process group is torn down before it
    returns."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = SHAPES[shape]
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return dict(arch=arch, shape=shape, skipped=True,
                    reason="full attention: no sub-quadratic path")
    chips = 512 if multi_pod else 256
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        rec = _drive(cfg, cell, mesh, opt_name, seq_shard)
        del mesh
    return dict(arch=arch, shape=shape, **rec, overrides=overrides or {}, skipped=False)


def _drive(cfg, cell, mesh, opt_name, seq_shard) -> Dict[str, Any]:
    chips = mesh.size()
    t0 = time.perf_counter()
    pol = make_policy(mesh, cfg, cell.global_batch, seq_shard=seq_shard)
    model = abstract_model(cfg)
    shard_model(pol, model)
    data = {k: torch.zeros(v.shape, dtype=v.dtype, device="meta")
            for k, v in input_specs(cfg, cell).items()}
    REPLICATED.clear()
    opt_state = cache = None
    counter = StepCounter()
    if cell.kind == "train":
        optimizer = AdamW(lr=3e-4, quantize_moments=(opt_name == "adamw8bit"))
        from ..models import lm_param_leaves

        opt_state = optimizer.init(lm_param_leaves(cfg, model))
        step = make_train_step(model, cfg, optimizer, policy=pol)
        t_setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        with CommDebugMode() as comm, counter:
            step(opt_state, data)
    elif cell.kind == "prefill":
        prefill = make_prefill_fn(model, cfg, policy=pol, cache_len=cell.seq_len)
        extras = {k: v for k, v in data.items() if k != "tokens"}
        t_setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        with CommDebugMode() as comm, counter:
            cache, _ = prefill(data["tokens"], extras or None)
    else:
        B, S = cell.global_batch, cell.seq_len
        cache = model.init_cache(B, S, S) if cfg.encdec else model.init_cache(B, S)
        cache = shard_cache(pol, cache, B)
        serve = make_serve_step(model, cfg, policy=pol)
        t_setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        with CommDebugMode() as comm, counter:
            serve(cache, data["token"], torch.zeros((), dtype=torch.int32, device="meta"))
    t_step = time.perf_counter() - t0
    param_bytes = local_bytes(model.parameters())
    opt_bytes = local_bytes(t for k, v in (opt_state or {}).items() if k != "leaves"
                            for t in tensors_of(v))
    cache_bytes = local_bytes(tensors_of(cache)) if cell.kind != "train" else 0
    inputs = list(shard_batch(pol, data).values())
    input_bytes = local_bytes(inputs)
    held = list(model.parameters()) + tensors_of(cache) + inputs + [
        t for k, v in (opt_state or {}).items() if k != "leaves" for t in tensors_of(v)]
    allocated = local_bytes(t for t in held if not _local(t).is_meta)
    batch_axes, fsdp, replicated = list(pol.batch_axes), pol.fsdp, dict(REPLICATED)
    del model, opt_state, cache, data, pol
    flops_dev = float(counter.flops)
    coll = counter.total_collective_bytes
    terms = roofline_terms(flops_dev, float(counter.op_bytes), float(coll))
    model_flops_dev = model_flops(cfg, cell) / chips
    return dict(
        mesh="x".join(str(n) for n in mesh.shape), chips=chips,
        kind=cell.kind, opt=opt_name if cell.kind == "train" else None, seq_shard=seq_shard,
        batch_axes=batch_axes, fsdp=fsdp,
        n_params=cfg.n_params(), n_active_params=cfg.n_active_params(),
        param_bytes=param_bytes, opt_bytes=opt_bytes, cache_bytes=cache_bytes,
        input_bytes=input_bytes, allocated_bytes=allocated,
        flops_per_device=flops_dev, op_bytes_per_device=float(counter.op_bytes),
        collective_bytes=coll, collective_by_kind=dict(counter.collective_bytes),
        collective_counts=dict(counter.collective_counts),
        comm_debug_mode_count=comm.get_total_counts(),
        roofline=terms, roofline_peaks=PEAKS, dominant=dominant_term(terms),
        model_flops_per_device=model_flops_dev,
        useful_flops_ratio=model_flops_dev / flops_dev if flops_dev else None,
        replicated_ops=replicated,
        setup_s=round(t_setup, 2), step_s=round(t_step, 2),
    )


def lower_snn_cell(*, k: int = 256, scale: float = 0.5, exchange: str = "dense",
                   cap_frac: float = 0.25, seed: int = 0) -> Dict[str, Any]:
    """The paper's own system at pod scale, worked out on the host: the
    microcircuit partitioned by ``rcb_partition`` into ``k`` uniform dCSR
    partitions, one a device, stacked into the k>1 engine's panels
    (``snn/dist_sim.py:stack_partitions``, ``align_k=128``), with no device
    and no step run.  Per device and step: 2 FLOPs a padded ELL slot (the
    reference's analytic compute term); the bytes its step must move (its
    panels' cols and weights, 8 B a padded slot, the gathered (n,)
    activity read once a bucket, its state and ring slot read and
    written); and the exchange, one all-gather charged its operand, as the
    reference charges each HLO collective: the partition's f32 spikes
    (dense) or its ``cap`` int64 spike ids (index; the reference's are
    int32).  The compute term is over the f32 peak: the gathers are f32
    multiply-adds outside the tensor cores."""
    from ..analysis.roofline import F32_PEAK_FLOPS
    from ..core.partition import rcb_partition
    from ..snn import SimConfig, microcircuit, to_dcsr
    from ..snn.dist_sim import stack_partitions

    t0 = time.perf_counter()
    net = microcircuit(scale=scale, seed=seed)
    d = to_dcsr(net, assignment=rcb_partition(net.coords, k), uniform=True)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = SimConfig(exchange=exchange, align_k=128, index_cap_frac=cap_frac)
    s = stack_partitions(d, cfg)
    t_stack = time.perf_counter() - t0
    slots = sum(c.size for c in s.cols)
    real = sum(int(v.sum()) for v in s.valid)
    n_p, nd = s.n_p, len(s.cols)
    state_bytes = s.vtx_state0[0].size * s.vtx_state0.itemsize
    bytes_dev = 8 * slots / k + nd * 4 * d.n + 2 * state_bytes + 2 * 4 * n_p
    if exchange == "dense":
        operand, received = 4 * n_p, 4 * d.n
    else:
        cap = max(int(cap_frac * n_p), 8)
        operand, received = 8 * cap, 8 * cap * k
    flops_dev = 2.0 * slots / k
    terms = roofline_terms(flops_dev, bytes_dev, operand, peak_flops=F32_PEAK_FLOPS)
    return dict(
        arch="snn-microcircuit", shape=f"k{k}_scale{scale}_{exchange}", mesh=f"{k}x1",
        chips=k, kind="simulate", n=d.n, m=d.m, n_p=n_p, buckets=nd,
        panel_shapes=[list(c.shape) for c in s.cols], ell_slots=slots, real_slots=real,
        fill=real / slots, flops_per_device=flops_dev, bytes_per_device=bytes_dev,
        collective_bytes=operand, collective_by_kind={"all-gather": operand},
        collective_counts={"all-gather": 1}, received_bytes=received,
        roofline=terms, roofline_peaks=PEAKS, dominant=dominant_term(terms),
        build_s=round(t_build, 2), stack_s=round(t_stack, 2), skipped=False,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--opt", default="adamw", choices=["adamw", "adamw8bit"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--override", default="",
                    help="comma-separated ArchConfig overrides, e.g. "
                         "'moe_impl=ep_shard_map,remat=True'")
    ap.add_argument("--snn", action="store_true",
                    help="work out the distributed SNN simulator's cell instead")
    ap.add_argument("--snn-k", type=int, default=256)
    ap.add_argument("--snn-scale", type=float, default=0.5)
    ap.add_argument("--snn-exchange", default="dense", choices=["dense", "index"])
    ap.add_argument("--snn-cap", type=float, default=0.25)
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.override)
    if args.snn:
        os.makedirs(args.out, exist_ok=True)
        rec = lower_snn_cell(k=args.snn_k, scale=args.snn_scale, exchange=args.snn_exchange,
                             cap_frac=args.snn_cap)
        name = f"snn__{rec['shape']}" + (f"_cap{args.snn_cap}" if args.snn_exchange == "index"
                                         else "")
        with open(os.path.join(args.out, name + ".json"), "w") as f:
            json.dump(rec, f, indent=1, default=str)
        r = rec["roofline"]
        print(f"[snn-dryrun] {name} n={rec['n']} m={rec['m']} slots={rec['ell_slots']} "
              f"build={rec['build_s']}s compute={r['compute_s']:.2e} mem={r['memory_s']:.2e} "
              f"coll={r['collective_s']:.2e} dom={rec['dominant']}")
        return
    archs = [args.arch] if args.arch else list(ARCHS)
    meshes = [False] if args.mesh == "single" else [True] if args.mesh == "multi" \
        else [False, True]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        cells = [SHAPES[args.shape]] if args.shape else list(cells_for(get_config(arch)))
        for cell in cells:
            for mp in meshes:
                tag = f"_{args.tag}" if args.tag else ""
                name = f"{arch}__{cell.name}__{'multi' if mp else 'single'}{tag}"
                path = os.path.join(args.out, name + ".json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        if "error" not in json.load(f):
                            print(f"[skip-existing] {name}")
                            continue
                print(f"[dryrun] {name} ...", flush=True)
                try:
                    rec = lower_cell(arch, cell.name, multi_pod=mp, opt_name=args.opt,
                                     seq_shard=not args.no_seq_shard, overrides=overrides)
                    rec["tag"] = args.tag
                except Exception as e:  # one cell's failure is recorded, the sweep goes on
                    traceback.print_exc()
                    failures.append(name)
                    rec = dict(arch=arch, shape=cell.name, mesh="multi" if mp else "single",
                               error=str(e)[:2000], skipped=False)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1, default=str)
                if rec.get("skipped"):
                    print(f"  -> skipped ({rec['reason']})")
                elif "error" in rec:
                    print("  -> ERROR")
                else:
                    r = rec["roofline"]
                    print(f"  -> ok step={rec['step_s']}s params={rec['param_bytes'] / 2**30:.3f} "
                          f"GiB opt={rec['opt_bytes'] / 2**30:.3f} GiB "
                          f"cache={rec['cache_bytes'] / 2**30:.3f} GiB "
                          f"compute={r['compute_s']:.2e}s mem={r['memory_s']:.2e}s "
                          f"coll={r['collective_s']:.2e}s dom={rec['dominant']}", flush=True)
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
