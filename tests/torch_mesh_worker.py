"""The port's mesh half across processes: 4 CPU ranks over gloo, run by
``tests/test_torch_sharding.py`` (one launch for the module).

    python tests/torch_mesh_worker.py OUT_DIR MOE_NPZ...

Every rank builds the same reduced models from the same seed; rank 0
writes ``OUT_DIR/results.json`` (the measured gaps, each check's numbers)
and ``OUT_DIR/ep_<case>.npz`` (the port's EP output and gradients on the
given weights).  Checks:

  * the MoE's ``ep_shard_map`` path against its ``gspmd`` path under the
    policy and against the unsharded module, on the 2x2 ``("data",
    "model")`` mesh and, padded (6 experts over 4 model ranks), on a 1x4
    mesh;
  * smollm-135m and granite-moe-3b-a800m ``reduced()``: 2 train steps
    under the policy (the model's parameters DTensors) against 2 without,
    then a prefill and a decode step;
  * AdamW (fp32 and 8-bit moments) and SGDM on DTensor parameters against
    plain ones, given the same gradients;
  * the sharded run's checkpoint tree gathered and written, against the
    same values written from an unsharded model.
"""
import dataclasses
import json
import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def gap(a, b) -> float:
    from torch.distributed.tensor import DTensor

    a = a.full_tensor() if isinstance(a, DTensor) else a
    b = b.full_tensor() if isinstance(b, DTensor) else b
    return float((a.detach().float() - b.detach().float()).abs().max())


def rel_gap(a, b) -> float:
    from torch.distributed.tensor import DTensor

    b = b.full_tensor() if isinstance(b, DTensor) else b
    return gap(a, b) / (float(b.detach().abs().max()) + 1e-9)


def moe_case(name, path, mesh, out_dir, res):
    from repro_torch.configs import get_config
    from repro_torch.models import ParamLeaf
    from repro_torch.models.moe import MoE
    from repro_torch.sharding.policy import distribute, make_policy, policy_context, shard_model

    w = np.load(path)
    base = get_config("granite-moe-3b-a800m").reduced()
    cfg = dataclasses.replace(base, n_experts=int(w["n_experts"]), top_k=int(w["top_k"]),
                              capacity_factor=8.0)
    x = torch.from_numpy(w["x"])

    def module(impl):
        m = MoE(dataclasses.replace(cfg, moe_impl=impl), torch.float32, "cpu",
                torch.Generator().manual_seed(0))
        with torch.no_grad():
            for k in ("w_router", "experts_in", "experts_gate", "experts_out"):
                getattr(m, k).copy_(torch.from_numpy(w[k]))
        return m

    def run(m, pol):
        ps = [m.w_router, m.experts_in, m.experts_gate, m.experts_out]
        with policy_context(pol):
            xin = x if pol is None else distribute(pol, x, (pol.batch_axes or None, None, None))
            out, aux = m(xin)
            grads = torch.autograd.grad((out ** 2).sum(), ps)
        full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
        return full(out).detach(), {k: float(full(v)) for k, v in aux.items()}, \
            [full(g) for g in grads]

    plain_out, plain_aux, plain_g = run(module("gspmd"), None)
    got = {}
    for impl in ("gspmd", "ep_shard_map"):
        m = module(impl)
        pol = make_policy(mesh, m.cfg, x.shape[0])
        # the reference's leaf paths of a stacked MoE layer
        leaves = [ParamLeaf(("groups", 0, "mlp", k), (1,) + tuple(getattr(m, k).shape),
                            [getattr(m, k)], True)
                  for k in ("experts_gate", "experts_in", "experts_out", "w_router")]
        shard_model(pol, m, leaves=leaves)
        got[impl] = run(m, pol)
    ep_out, ep_aux, ep_g = got["ep_shard_map"]
    sp_out, sp_aux, sp_g = got["gspmd"]
    res[name] = dict(
        ep_vs_gspmd_fwd=gap(ep_out, sp_out), ep_vs_plain_fwd=gap(ep_out, plain_out),
        gspmd_vs_plain_fwd=gap(sp_out, plain_out),
        ep_vs_gspmd_grad_rel=max(rel_gap(a, b) for a, b in zip(ep_g, sp_g)),
        ep_vs_plain_grad_rel=max(rel_gap(a, b) for a, b in zip(ep_g, plain_g)),
        aux_gap=max(abs(ep_aux[k] - plain_aux[k]) for k in plain_aux),
        out_scale=float(plain_out.abs().max()),
    )
    if dist.get_rank() == 0:
        np.savez(os.path.join(out_dir, f"ep_{name}.npz"), out=ep_out.numpy(),
                 aux=np.array([ep_aux[k] for k in sorted(ep_aux)], np.float32),
                 **{f"g{i}": g.numpy() for i, g in enumerate(ep_g)})


def lm_case(arch, mesh, out_dir, res):
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.io import CheckpointManager
    from repro_torch.models import build_model, lm_param_leaves
    from repro_torch.sharding.policy import make_policy, shard_model
    from repro_torch.train import AdamW, make_prefill_fn, make_serve_step, make_train_step

    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(7)
    B, S = 4, 16
    batches = [{"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}
               for _ in range(2)]
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 8)).astype(np.int32))
    opt = AdamW(lr=1e-3)
    runs = {}

    def build(c, sharded):
        model = build_model(c, device="cpu")
        pol = make_policy(mesh, c, B) if sharded else None
        if sharded:
            shard_model(pol, model)
        return model, pol

    for tag in ("plain", "sharded"):
        # training takes the gspmd MoE: the EP path's aux losses are means of
        # per-batch-shard values (the reference's too), not the global ones
        model, pol = build(cfg, tag == "sharded")
        state = opt.init(lm_param_leaves(cfg, model))
        step = make_train_step(model, cfg, opt, policy=pol)
        losses = []
        for b in batches:
            state, metrics = step(state, b)
            losses.append(metrics["loss"])
        # serving from fresh weights, the sharded MoE on the EP path
        c = dataclasses.replace(cfg, moe_impl="ep_shard_map") if cfg.moe and pol else cfg
        smodel, spol = build(c, tag == "sharded")
        prefill = make_prefill_fn(smodel, c, policy=spol, cache_len=prompt.shape[1] + 1)
        cache, logits = prefill(prompt)
        nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
        serve = make_serve_step(smodel, c, policy=spol)
        dec, cache = serve(cache, nxt, torch.tensor(prompt.shape[1], dtype=torch.int32))
        runs[tag] = dict(losses=losses, prefill=logits, decode=dec,
                         tree=convert.lm_train_tree(cfg, model, state))
    p, s = runs["plain"], runs["sharded"]
    pleaves = convert._flatten(p["tree"], "", {})
    sleaves = convert._flatten(s["tree"], "", {})
    params = [k for k in pleaves if k.startswith("params")]
    res[arch] = dict(
        loss_gap=max(abs(float(a) - float(b)) for a, b in zip(p["losses"], s["losses"])),
        losses=[float(v) for v in s["losses"]],
        param_gap=max(float(np.abs(pleaves[k] - sleaves[k]).max()) for k in params),
        prefill_gap=gap(s["prefill"], p["prefill"]), decode_gap=gap(s["decode"], p["decode"]),
        logit_scale=float(p["decode"].abs().max()),
        same_prefill_argmax=bool(torch.equal(s["prefill"].argmax(-1), p["prefill"].argmax(-1))),
        same_decode_argmax=bool(torch.equal(s["decode"].argmax(-1), p["decode"].argmax(-1))),
    )
    # the sharded run's checkpoint: its gathered tree loaded into an
    # unsharded model and written again holds the same bytes
    model_u = build_model(cfg, device="cpu")
    model_u.load_state_dict(convert.lm_params_from_arrays(cfg, s["tree"]["params"]))
    state_u = convert.lm_opt_state_from_arrays(cfg, model_u, s["tree"]["opt_state"])
    tree_u = convert.lm_train_tree(cfg, model_u, state_u)
    if dist.get_rank() == 0:
        dirs = []
        for tag, tree in (("sharded", s["tree"]), ("unsharded", tree_u)):
            root = os.path.join(out_dir, f"ckpt_{arch}_{tag}")
            CheckpointManager(root, async_write=False).save(2, tree, wait=True)
            dirs.append(os.path.join(root, "step_00000002"))
        files = sorted(os.listdir(dirs[0]))
        res[arch]["ckpt_files"] = len(files)
        res[arch]["ckpt_same_names"] = files == sorted(os.listdir(dirs[1]))
        res[arch]["ckpt_differ"] = [f for f in files if open(os.path.join(dirs[0], f), "rb").read()
                                    != open(os.path.join(dirs[1], f), "rb").read()]


def opt_case(mesh, res):
    """Each optimizer's update on DTensor parameters against the same update
    on plain ones, given the same gradients (granite reduced: stacked,
    expert and 1-D leaves): the states and parameters byte-equal without
    clipping (the update is elementwise on each shard, the 8-bit one
    replicated on whole leaves); with clipping the norm's sums run in
    another order."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, lm_param_leaves
    from repro_torch.sharding.policy import distribute, make_policy, shard_model
    from repro_torch.train import SGDM, AdamW
    from repro_torch.train.optimizer import flat_params

    cfg = get_config("granite-moe-3b-a800m").reduced()
    g = torch.Generator().manual_seed(3)
    out = {}
    for name, opt in (("adamw", AdamW(lr=1e-3, clip_norm=None)),
                      ("adamw8bit", AdamW(lr=1e-3, clip_norm=None, quantize_moments=True)),
                      ("sgdm", SGDM(lr=1e-2, clip_norm=None)),
                      ("adamw_clipped", AdamW(lr=1e-3, clip_norm=0.5))):
        trees = []
        for sharded in (False, True):
            model = build_model(cfg, device="cpu")
            pol = make_policy(mesh, cfg, 4) if sharded else None
            specs = shard_model(pol, model) if sharded else None
            state = opt.init(lm_param_leaves(cfg, model))
            for _ in range(2):
                grads = [torch.randn(p.shape, generator=g) for p in flat_params(state)]
                if sharded:
                    names = {id(p): n for n, p in model.named_parameters()}
                    grads = [distribute(pol, gr, specs[names[id(p)]])
                             for gr, p in zip(grads, flat_params(state))]
                state, _ = opt.update(grads, state)
            g.manual_seed(3)
            trees.append(convert._flatten(convert.lm_train_tree(cfg, model, state), "", {}))
        a, b = trees
        out[name] = dict(
            differ=[k for k in a if a[k].tobytes() != b[k].tobytes()],
            gap=max(float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in a))
    res["optimizers"] = out


def rows_by_coordinate(mesh):
    """The rows of an (8, 3) tensor each rank holds under the spec
    ``(("data", "model"), None)``, by mesh coordinate."""
    from repro_torch.sharding.policy import distribute, make_policy
    from repro_torch.configs import get_config

    pol = make_policy(mesh, get_config("smollm-135m"), 8)
    x = torch.arange(24).reshape(8, 3)
    local = distribute(pol, x, (("data", "model"), None)).to_local()
    mine = (",".join(str(c) for c in mesh.get_coordinate()), (local[:, 0] // 3).tolist())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return dict(every)


def worker(rank, port, out_dir, moe_files):
    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=WORLD)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        mesh22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        mesh14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
        res = {"rows": rows_by_coordinate(mesh22)}
        for path in moe_files:
            name = os.path.basename(path)[:-4]
            moe_case(name, path, mesh14 if "padded" in name else mesh22, out_dir, res)
        for arch in ("smollm-135m", "granite-moe-3b-a800m"):
            lm_case(arch, mesh22, out_dir, res)
        opt_case(mesh22, res)
        from repro_torch.sharding.policy import REPLICATED

        res["replicated_ops"] = dict(REPLICATED)
        if rank == 0:
            with open(os.path.join(out_dir, "results.json"), "w") as f:
                json.dump(res, f, indent=1)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv):
    out_dir, moe_files = argv[0], argv[1:]
    mp.start_processes(worker, args=(_free_port(), out_dir, moe_files), nprocs=WORLD,
                       start_method="spawn", join=True)


if __name__ == "__main__":
    main(sys.argv[1:])
