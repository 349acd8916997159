"""The port's mesh half against the reference's: the sharding policy's
specs, the expert-parallel MoE, sharded training and serving, the sharded
checkpoint and the dry run.

  * In this process (no process group): every parameter spec of every arch
    on both production meshes, every activation spec, the batch-axis and
    FSDP choices, and the optimizer-state and cache specs, each equal to
    the reference's (``repro.compat.abstract_mesh``, no devices).
  * One module-scoped launch (``mesh_run``) runs, side by side, the
    reference's EP MoE as an oracle in a subprocess with 4 fake XLA devices
    on an Auto-axis mesh (``jax.make_mesh`` gives Explicit axes on this jax,
    which the reference's ``constrain`` refuses: ROADMAP F6), and
    ``tests/torch_mesh_worker.py`` on 4 CPU ranks over gloo; both read the
    same weights, drawn here with numpy.
  * In the same launch, a dry run over a fake 256/512-rank process group,
    whose bytes per device are held against the reference's specs.

No process group is left in this process.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from helpers import REPO, run_with_devices
from repro.compat import abstract_mesh
from repro.configs import ARCHS, SHAPES, cells_for
from repro.configs import get_config as jget
from repro.launch import specs as jspecs
from repro.models import build_model as jbuild
from repro.sharding import policy as jpol
from repro.train.optimizer import AdamW as JAdamW
from repro_torch.configs import get_config
from repro_torch.launch import specs as tspecs
from repro_torch.sharding import policy as tpol
from repro_torch.train import AdamW

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    sizes, axes = MESHES[name]
    return abstract_mesh(sizes, axes), dict(zip(axes, sizes))


def _path(kp) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


_SDS = {}


def _ref_params(arch):
    if arch not in _SDS:
        _SDS[arch] = jax.eval_shape(jbuild(jget(arch)).init, jax.random.PRNGKey(0))
    return _SDS[arch]


_MODELS = {}


def _port_model(arch):
    if arch not in _MODELS:
        _MODELS[arch] = tspecs.abstract_model(get_config(arch))
    return _MODELS[arch]


# -- specs, in this process ---------------------------------------------------------

@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_the_reference(arch, mesh_name):
    """Every leaf of the port's model (``lm_param_leaves``: the reference's
    paths and stacked shapes) takes the reference's spec, and each port
    parameter the spec without the stack dim."""
    jmesh, axes = _meshes(mesh_name)
    jp = jpol.make_policy(jmesh, jget(arch), 256)
    tp = tpol.make_policy(axes, get_config(arch), 256)
    assert (tp.batch_axes, tp.fsdp) == (jp.batch_axes, jp.fsdp)
    want = {_path(kp): (tuple(leaf.shape), tuple(jpol.param_spec(jp, _path(kp), tuple(leaf.shape))))
            for kp, leaf in jax.tree_util.tree_flatten_with_path(_ref_params(arch))[0]}
    leaves = tspecs.params_specs(_port_model(arch), get_config(arch))
    got = {tspecs.leaf_path(leaf): (leaf.shape, spec)
           for leaf, spec in zip(leaves, tspecs.param_shardings(tp, leaves))}
    assert got == want
    per_param = tpol.leaf_param_specs(tp, leaves)
    for leaf in leaves:
        spec = got[tspecs.leaf_path(leaf)][1]
        for p in leaf.params:
            assert per_param[id(p)] == (spec[1:] if leaf.stacked else spec)


def _activation_cases(cfg, cell):
    B, S, d = cell.global_batch, cell.seq_len, cfg.d_model
    E = cfg.n_experts or 16
    return [("btd", (B, S, d)), ("btd", (B, 1, d)), ("btf", (B, S, cfg.d_ff or d)),
            ("bthd", (B, S, cfg.n_heads, cfg.hd)), ("bthd", (B, 1, cfg.n_heads, cfg.hd)),
            ("logits", (B, S, cfg.vocab_size)), ("moe_becd", (B, E, 8, d)),
            ("moe_becd", (B, 40, 8, d)), ("unknown", (B, S, d))]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_activation_specs_match_the_reference(arch):
    for mesh_name in MESHES:
        jmesh, axes = _meshes(mesh_name)
        for cell in cells_for(jget(arch)):
            for seq_shard in (False, True):
                for ctx in (False, True):
                    jcfg = dataclasses.replace(jget(arch), ctx_parallel=ctx)
                    tcfg = dataclasses.replace(get_config(arch), ctx_parallel=ctx)
                    jp = jpol.make_policy(jmesh, jcfg, cell.global_batch, seq_shard=seq_shard)
                    tp = tpol.make_policy(axes, tcfg, cell.global_batch, seq_shard=seq_shard)
                    for kind, shape in _activation_cases(tcfg, cell):
                        want = jpol.activation_spec(jp, kind, shape)
                        got = tpol.activation_spec(tp, kind, shape)
                        assert got == (None if want is None else tuple(want)), \
                            (mesh_name, cell.name, kind, shape)


def test_batch_axes_selection():
    _, axes = _meshes("multi")
    cfg = get_config("smollm-135m")
    assert tpol.make_policy(axes, cfg, 256).batch_axes == ("pod", "data")
    assert tpol.make_policy(axes, cfg, 32).batch_axes == ("pod", "data")
    assert tpol.make_policy(axes, cfg, 1).batch_axes == ()
    assert tpol.make_policy(axes, cfg, 2).batch_axes == ("pod",)


def test_fsdp_threshold():
    _, axes = _meshes("single")
    assert tpol.make_policy(axes, get_config("command-r-35b"), 256).fsdp
    assert not tpol.make_policy(axes, get_config("smollm-135m"), 256).fsdp


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_opt_shardings_match_the_reference(arch):
    """AdamW's moments (fp32 and 8-bit) take the reference's specs, leaf by
    leaf, on both meshes."""
    leaves = tspecs.params_specs(_port_model(arch), get_config(arch))
    jsds = _ref_params(arch)
    cell = SHAPES["train_4k"]
    for mesh_name in MESHES:
        jmesh, axes = _meshes(mesh_name)
        jp = jpol.make_policy(jmesh, jget(arch), cell.global_batch)
        tp = tpol.make_policy(axes, get_config(arch), cell.global_batch)
        p_shard = jpol.param_shardings(jp, jsds)
        p_specs = tspecs.param_shardings(tp, leaves)
        for q8 in (False, True):
            jo = JAdamW(quantize_moments=q8)
            to = AdamW(quantize_moments=q8)
            want = jspecs.opt_shardings(jspecs.opt_specs(jo, jsds), p_shard, jp, jo)
            got = tspecs.opt_shardings(tspecs.opt_specs(to, leaves), p_specs, tp, to)
            assert got["count"] == tuple(want["count"].spec)
            for key in ("m", "v"):
                flat = [tuple(s.spec) for s in jax.tree.leaves(
                    want[key], is_leaf=lambda x: hasattr(x, "spec"))]
                mine = [s for d in got[key] for s in ([d[k] for k in sorted(d)]
                                                      if isinstance(d, dict) else [d])]
                assert mine == flat, (mesh_name, q8, key)


def _ref_cache_layer_specs(cfg, tree, n_layers):
    """The reference's decoder cache specs per port layer: a stacked
    ``groups`` leaf's spec without its stack dim, a ``rest`` leaf's as is."""
    P = cfg.pattern_period
    n_groups = n_layers // P if cfg.layer_stack == "scan" else 0
    out = []
    for g in range(n_groups):
        for j in range(P):
            out.append({k: s[1:] for k, s in tree["groups"][j].items()})
    return out + [dict(layer) for layer in tree["rest"]]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_shardings_match_the_reference(arch):
    """Each decode cell's cache specs on both meshes.  A decoder layer's
    entry takes its stacked leaf's spec without the stack dim; the one rule
    the port cannot follow is "model" on the stack dim itself (a (G, B, nh)
    mLSTM stabilizer with ``G`` a multiple of 16 and no batch axis), which
    no per-layer tensor has."""
    jcfg, tcfg = jget(arch), get_config(arch)
    for cell in cells_for(jcfg):
        if cell.kind != "decode":
            continue
        for mesh_name in MESHES:
            jmesh, axes = _meshes(mesh_name)
            jp = jpol.make_policy(jmesh, jcfg, cell.global_batch)
            tp = tpol.make_policy(axes, tcfg, cell.global_batch)
            jc = jspecs.cache_specs(jbuild(jcfg), jcfg, cell)
            want = jax.tree.map(lambda s: tuple(s.spec),
                                jspecs.cache_shardings(jc, jcfg, cell, jp),
                                is_leaf=lambda x: hasattr(x, "spec"))
            got = tspecs.cache_shardings(tspecs.cache_specs(_port_model(arch), tcfg, cell),
                                         tcfg, cell, tp)
            if tcfg.encdec:
                assert got == {k: v for k, v in want.items()}
                continue
            ref = _ref_cache_layer_specs(jcfg, want, jcfg.n_layers)
            assert len(ref) == len(got)
            for i, (g, r) in enumerate(zip(got, ref)):
                assert sorted(g) == sorted(r), i
                for k in g:
                    r_k = tuple(r[k]) + (None,) * (len(g[k]) - len(r[k]))
                    assert g[k] == r_k, (mesh_name, cell.name, i, k)


def test_placements_follow_the_mesh_order():
    axes = {"pod": 2, "data": 16, "model": 16}
    P = tpol.placements(axes, (("pod", "data"), None, "model"))
    assert [type(p).__name__ for p in P] == ["Shard", "Shard", "Shard"]
    assert [p.dim for p in P] == [0, 0, 2]
    with pytest.raises(ValueError, match="axis order"):
        tpol.placements(axes, (("data", "pod"), None))
    assert tpol.local_shape(axes, (("pod", "data"), None, "model"), (64, 3, 32)) == (2, 3, 2)
    assert tpol.q8_spec(axes, (4, 1024, 128)) == (None, ("pod", "data", "model"), None)
    assert tpol.q8_spec(axes, (1, 3, 1)) == ()


def test_constrain_and_replicated_are_the_identity_without_a_policy():
    x = torch.arange(6.0).reshape(2, 3)
    assert tpol.constrain(x, "btd") is x
    before = dict(tpol.REPLICATED)
    assert torch.equal(tpol.replicated("t", torch.neg, x), -x)
    assert dict(tpol.REPLICATED) == before
    pol = tpol.make_policy({"data": 2, "model": 2}, get_config("smollm-135m"), 4)
    with tpol.policy_context(pol):  # no mesh: specs only, plain tensors untouched
        assert tpol.current_policy() is pol
        assert tpol.constrain(x, "btd") is x
    assert tpol.current_policy() is None


# -- across processes ---------------------------------------------------------------

EP_ORACLE = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models.moe import moe_apply
from repro.sharding.policy import make_policy, policy_context

out_dir = sys.argv[1]
for name, shape in (("moe", (2, 2)), ("moe_padded", (1, 4))):
    w = np.load(f"{out_dir}/{name}.npz")
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(),
                              n_experts=int(w["n_experts"]), top_k=int(w["top_k"]),
                              capacity_factor=8.0, moe_impl="ep_shard_map")
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    pol = make_policy(mesh, cfg, w["x"].shape[0])
    p = {k: jnp.asarray(w[k]) for k in ("w_router", "experts_in", "experts_gate", "experts_out")}
    x = jnp.asarray(w["x"])

    def fwd(p):
        with policy_context(pol):
            return moe_apply(p, x, cfg)

    with mesh:
        out, aux = jax.jit(fwd)(p)
        g = jax.jit(jax.grad(lambda p: jnp.sum(fwd(p)[0] ** 2)))(p)
    np.savez(f"{out_dir}/ref_{name}.npz", out=np.asarray(out),
             aux=np.array([float(aux[k]) for k in sorted(aux)], np.float32),
             **{f"g{i}": np.asarray(g[k]) for i, k in enumerate(
                 ("w_router", "experts_in", "experts_gate", "experts_out"))})
# a dim over two axes: the rows each device holds, by mesh coordinate
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
idx = NamedSharding(mesh, P(("data", "model"), None)).devices_indices_map((8, 3))
rows = {}
for i in range(2):
    for j in range(2):
        sl = idx[mesh.devices[i, j]][0]
        rows[f"{i},{j}"] = list(range(8))[sl]
import json
json.dump(rows, open(f"{out_dir}/ref_rows.json", "w"))
print("ORACLE OK")
"""


def _weights(out_dir):
    def trunc(rng, shape, scale):
        return (np.clip(rng.standard_normal(shape), -2, 2) * scale).astype(np.float32)

    paths = []
    for name, E in (("moe", 4), ("moe_padded", 6)):
        rng = np.random.default_rng(11)
        d, ff = 64, 128
        path = os.path.join(out_dir, name + ".npz")
        np.savez(path, n_experts=E, top_k=2, x=rng.standard_normal((4, 16, d)).astype(np.float32),
                 w_router=trunc(rng, (d, E), d ** -0.5),
                 experts_in=trunc(rng, (E, d, ff), d ** -0.5),
                 experts_gate=trunc(rng, (E, d, ff), d ** -0.5),
                 experts_out=trunc(rng, (E, ff, d), ff ** -0.5))
        paths.append(path)
    return paths


DRY_LAYERS = 1  # the dry run's depth here: the bytes scale with it, the rules do not


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The oracle, the 4-rank gloo worker and the dry run, launched
    together; ``(out_dir, the worker's results)``."""
    out = str(tmp_path_factory.mktemp("mesh"))
    paths = _weights(out)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for cmd in (
        [sys.executable, os.path.join(REPO, "tests", "torch_mesh_worker.py"), out, *paths],
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "smollm-135m", "--shape",
         "train_4k", "--mesh", "both", "--override", f"n_layers={DRY_LAYERS}", "--out",
         os.path.join(out, "dryrun")])]
    try:
        oracle = run_with_devices(EP_ORACLE.replace("sys.argv[1]", repr(out)), n_devices=4)
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert "ORACLE OK" in oracle
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    with open(os.path.join(out, "results.json")) as f:
        return out, json.load(f)


CASES = ["moe", "moe_padded"]


@pytest.mark.parametrize("case", CASES)
def test_ep_matches_gspmd(mesh_run, case):
    """The EP path equals the gspmd path under the policy and the unsharded
    module: forward within 1e-4, gradients within 1e-3 of their largest
    (the reference test's bounds); ``moe_padded`` pads 6 experts to 8 over
    a 4-rank model axis."""
    r = mesh_run[1][case]
    assert r["ep_vs_gspmd_fwd"] < 1e-4 and r["ep_vs_plain_fwd"] < 1e-4
    assert r["gspmd_vs_plain_fwd"] < 1e-4
    assert r["ep_vs_gspmd_grad_rel"] < 1e-3 and r["ep_vs_plain_grad_rel"] < 1e-3


@pytest.mark.parametrize("case", CASES)
def test_ep_matches_the_reference_ep(mesh_run, case):
    """The port's EP against the reference's on the same weights and mesh
    shape: the output within 1e-4, gradients within 1e-3 of their largest,
    and the aux scalars (means over the batch shards of per-shard values, in
    both) within 1e-5 relative."""
    out = mesh_run[0]
    mine = np.load(os.path.join(out, f"ep_{case}.npz"))
    ref = np.load(os.path.join(out, f"ref_{case}.npz"))
    assert np.abs(mine["out"] - ref["out"]).max() < 1e-4
    for i in range(4):
        a, b = mine[f"g{i}"], ref[f"g{i}"]
        assert np.abs(a - b).max() < 1e-3 * np.abs(b).max(), i
    np.testing.assert_allclose(mine["aux"], ref["aux"], rtol=1e-5, atol=1e-7)


LMS = ["smollm-135m", "granite-moe-3b-a800m"]


@pytest.mark.parametrize("arch", LMS)
def test_sharded_training_matches_unsharded(mesh_run, arch):
    """2 steps of AdamW (lr 1e-3) with the parameters as DTensors on the 2x2
    mesh against 2 without: each step's loss within 1e-5 relative, every
    parameter within 1e-4 (the sharded matmuls and gradient reductions sum
    in another order, and Adam turns a rounding-size gap in a near-zero
    gradient into up to a step's lr)."""
    r = mesh_run[1][arch]
    assert r["loss_gap"] <= 1e-5 * max(abs(v) for v in r["losses"])
    assert r["param_gap"] < 1e-4


@pytest.mark.parametrize("opt", ["adamw", "adamw8bit", "sgdm", "adamw_clipped"])
def test_sharded_optimizer_update_matches_plain(mesh_run, opt):
    """2 updates of each optimizer on DTensor parameters, given the plain
    run's gradients: every parameter and moment byte-equal (the 8-bit
    blocks included); with clipping, whose norm sums per shard, within
    1e-7."""
    r = mesh_run[1]["optimizers"][opt]
    if opt == "adamw_clipped":
        assert r["gap"] <= 1e-7
    else:
        assert r["differ"] == []


@pytest.mark.parametrize("arch", LMS)
def test_sharded_serving_matches_unsharded(mesh_run, arch):
    """A prefill and a decode step under the policy (granite's MoE on the EP
    path) against the unsharded run: logits within 1e-5 of their largest,
    the same greedy tokens."""
    r = mesh_run[1][arch]
    assert r["prefill_gap"] <= 1e-5 * r["logit_scale"]
    assert r["decode_gap"] <= 1e-5 * r["logit_scale"]
    assert r["same_prefill_argmax"] and r["same_decode_argmax"]


@pytest.mark.parametrize("arch", LMS)
def test_sharded_checkpoint_holds_the_unsharded_bytes(mesh_run, arch):
    r = mesh_run[1][arch]
    assert r["ckpt_files"] > 0 and r["ckpt_same_names"] and r["ckpt_differ"] == []


def test_two_axis_dim_holds_the_reference_devices_rows(mesh_run):
    """A dim over ``("data", "model")``: the rank at mesh coordinate (i, j)
    holds the rows JAX gives the device at (i, j)."""
    out, res = mesh_run
    with open(os.path.join(out, "ref_rows.json")) as f:
        assert res["rows"] == json.load(f)


def test_replicated_ops_are_counted_and_no_group_is_left(mesh_run):
    """The MoE routing and dispatch of the gspmd path and the prefill's
    cache writes ran replicated, each counted; this process holds no
    process group."""
    rep = mesh_run[1]["replicated_ops"]
    assert {"positions_in_expert", "moe_dispatch", "moe_combine"} <= set(rep)
    assert not dist.is_initialized()


# -- the dry run --------------------------------------------------------------------

def _ref_bytes(arch, mesh_name, overrides):
    """Per-device bytes of the parameters, AdamW's state and a train cell's
    tokens, worked out from the reference's specs."""
    jmesh, axes = _meshes(mesh_name)
    cfg = dataclasses.replace(jget(arch), **overrides)
    cell = SHAPES["train_4k"]
    jp = jpol.make_policy(jmesh, cfg, cell.global_batch)
    sds = jax.eval_shape(jbuild(cfg).init, jax.random.PRNGKey(0))
    p_shard = jpol.param_shardings(jp, sds)

    def nbytes(leaf, spec):
        return math.prod(tpol.local_shape(axes, tuple(spec), tuple(leaf.shape))) \
            * np.dtype(leaf.dtype).itemsize

    params = sum(nbytes(a, s.spec) for a, s in zip(jax.tree.leaves(sds), jax.tree.leaves(p_shard)))
    opt = JAdamW()
    osds = jspecs.opt_specs(opt, sds)
    o_shard = jspecs.opt_shardings(osds, p_shard, jp, opt)
    opt_bytes = sum(nbytes(a, s.spec) for a, s in zip(
        jax.tree.leaves(osds), jax.tree.leaves(o_shard, is_leaf=lambda x: hasattr(x, "spec"))))
    inp = jspecs.input_specs(cfg, cell)
    i_shard = jspecs.input_shardings(cfg, cell, jp)
    inputs = sum(nbytes(inp[k], i_shard[k].spec) for k in inp)
    return params, opt_bytes, inputs


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_dry_run_bytes_match_the_reference_specs(mesh_run, mesh_name):
    """``python -m repro_torch.launch.dryrun`` on a fake 256- and 512-rank
    group (smollm-135m ``train_4k``, one layer deep to keep the test short):
    a record each, nothing allocated, the bytes a device holds equal to
    those the reference's specs give, and the collectives the port counts
    those ``CommDebugMode`` counts."""
    chips = {"single": 256, "multi": 512}[mesh_name]
    with open(os.path.join(mesh_run[0], "dryrun",
                           f"smollm-135m__train_4k__{mesh_name}.json")) as f:
        rec = json.load(f)
    assert rec["chips"] == chips and rec["allocated_bytes"] == 0
    params, opt_bytes, inputs = _ref_bytes("smollm-135m", mesh_name, dict(n_layers=DRY_LAYERS))
    assert (rec["param_bytes"], rec["opt_bytes"], rec["input_bytes"]) == (params, opt_bytes, inputs)
    assert rec["flops_per_device"] > 0 and rec["collective_counts"]
    assert sum(rec["collective_counts"].values()) == rec["comm_debug_mode_count"]
    assert rec["dominant"] in ("compute_s", "memory_s", "collective_s")


@pytest.mark.parametrize("exchange", ["dense", "index"])
def test_snn_dry_run_matches_the_reference_panels(exchange):
    """``lower_snn_cell`` (``--snn``) at a small scale: the same net, the
    same ``rcb_partition`` and the same stacked panels as the reference's
    ``stack_partitions``, so the same ELL slots; 2 FLOPs a slot a device,
    and the exchange's operand (f32 spikes, or ``cap`` int64 ids)."""
    from repro.core import rcb_partition as jrcb
    from repro.snn import SimConfig as JSimConfig, microcircuit as jmicro, to_dcsr as jto_dcsr
    from repro.snn.dist_sim import stack_partitions as jstack
    from repro_torch.launch.dryrun import lower_snn_cell

    k, scale = 16, 0.02
    rec = lower_snn_cell(k=k, scale=scale, exchange=exchange)
    jnet = jmicro(scale=scale, seed=0)
    jd = jto_dcsr(jnet, assignment=jrcb(jnet.coords, k), uniform=True)
    js = jstack(jd, JSimConfig(exchange=exchange, align_k=128, index_cap_frac=0.25))
    assert (rec["n"], rec["m"], rec["n_p"]) == (jd.n, jd.m, js.n_p)
    assert rec["panel_shapes"] == [list(c.shape) for c in js.cols]
    assert rec["ell_slots"] == sum(int(np.prod(c.shape)) for c in js.cols)
    assert rec["flops_per_device"] == 2.0 * rec["ell_slots"] / k
    cap = max(int(0.25 * js.n_p), 8)
    assert rec["collective_bytes"] == (4 * js.n_p if exchange == "dense" else 8 * cap)
