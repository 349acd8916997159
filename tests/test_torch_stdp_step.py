"""``ops.stdp_update_step`` (every bucket of a step in one op) against the
reference, on the CPU.

Op level: the port's plain version against the reference's per-bucket
composition (``repro/snn/simulator.py:656-670``: per bucket
``repro.kernels.ops.stdp_update(backend="ref")`` with the post terms padded
to the bucket's rows or taken through a split bucket's ``row_map``), run op
by op (``jax.disable_jit()``), bit for bit in f32; once against
``backend="pallas_interpret"`` (the TPU kernel body).  Cases: unsplit
buckets with padding rows, split buckets with a row map, more than 32
buckets (two launch groups), NaN in the pre-trace at a non-plastic col,
plastic weights outside ``[w_min, w_max]`` with dw = 0, and ``-0.0``
weights.  The plan (:func:`stdp_step_plan`): the rows it lists, its launch
groups, its refusals.

Engine level: the unfused plastic engine at k=1, with ``max_k`` and at k=2
against the reference's rasters, traces and weights, one op call a
partition and step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import run_with_devices
from repro.kernels import ops as jops
from repro.snn import SimConfig as JSimConfig
from repro.snn import network as jnet
from repro.snn.simulator import Simulator as JSimulator
from repro_torch.core import block_partition
from repro_torch.kernels import dispatch, ops
from repro_torch.kernels import stdp_update as stdp_mod
from repro_torch.kernels.stdp_update import STEP_MAX_BUCKETS, stdp_step_plan
from repro_torch.snn import DistSimulator, SimConfig, Simulator
from repro_torch.snn import network as tnet
from repro_torch.snn.neurons import LIF_BIAS

# w_min/w_max inside the normal weights' range, so the clip is exercised
STDP = dict(a_plus=0.01, a_minus=0.012, w_min=-2.0, w_max=2.0)
STEPS = 40
N = 200
# added to balanced_ei(200)'s bias column in both packages, so that it
# spikes and learns within STEPS (tests/test_torch_maxk.py)
DRIVE = 10.0


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _bucket(rng, n, R, K, rows, split_rows=None, p_plastic=0.6):
    """One ELL panel of ``R`` rows, the first ``rows`` holding real slots
    (``row_len`` in ``[0, K]``, a few empty), ``(col 0, weight 0, mask 0)``
    past them.  ``split_rows``: the real row of each of the ``rows``
    virtual rows (nondecreasing); the padding rows map to row 0."""
    rl = rng.integers(0, K + 1, R).astype(np.int32)
    rl[rows:] = 0
    rl[rng.random(R) < 0.1] = 0
    real = np.arange(K)[None, :] < rl[:, None]
    cols = np.where(real, rng.integers(0, n, (R, K)), 0).astype(np.int32)
    w = np.where(real, rng.normal(size=(R, K)), 0.0).astype(np.float32)
    m = (real & (rng.random((R, K)) < p_plastic)).astype(np.float32)
    row_map = None
    if split_rows is not None:
        row_map = np.zeros(R, np.int32)
        row_map[:rows] = split_rows
    return dict(w=w, m=m, cols=cols, row_len=rl, row_map=row_map)


def _case(rng, name):
    """A step's buckets, its vectors and ``n_p`` for one named case."""
    n_p, n = 24, 60
    buckets = []
    if name in ("padded", "nan_pre_trace", "clip_dw0", "neg_zero", "interpret"):
        for K in (8, 16, 5):
            buckets.append(_bucket(rng, n, 32, K, n_p))
    elif name == "split":
        for K in (4, 8):
            # each real row 1-3 virtual rows; 8 padding virtual rows
            reps = rng.integers(1, 4, n_p)
            rows = np.repeat(np.arange(n_p), reps)
            buckets.append(_bucket(rng, n, len(rows) + 8, K, len(rows), split_rows=rows))
        buckets.append(_bucket(rng, n, 32, 6, n_p))  # one unsplit bucket beside them
    elif name == "many_buckets":
        for b in range(STEP_MAX_BUCKETS + 3):
            buckets.append(_bucket(rng, n, 26, 1 + b % 7, n_p))
    pre_t = rng.random(n).astype(np.float32)
    pre_s = (rng.random(n) < 0.3).astype(np.float32)
    post_t = rng.random(n_p).astype(np.float32)
    post_s = (rng.random(n_p) < 0.3).astype(np.float32)
    if name == "nan_pre_trace":
        c0 = 7  # every slot reading col 7 is made non-plastic
        for b in buckets:
            b["m"][b["cols"] == c0] = 0.0
        pre_t[c0] = np.nan
    elif name == "clip_dw0":
        # no spike: dw = 0 at every slot, so only the clip moves a weight
        pre_s[:], post_s[:] = 0.0, 0.0
        for b in buckets:
            b["w"] *= 3.0
    elif name == "neg_zero":
        # -0.0 + (0 - 0) is +0.0 at a plastic slot; a non-plastic -0.0 stays
        pre_s[:], post_s[:] = 0.0, 0.0
        for b in buckets:
            b["w"][:, ::2] = -0.0
    return n_p, buckets, (pre_t, pre_s, post_t, post_s)


def _reference(n_p, buckets, vecs, backend="ref", **kw):
    """The reference's per-bucket composition (its unfused step)."""
    pre_t, pre_s, post_t, post_s = map(jnp.asarray, vecs)
    out = []
    for b in buckets:
        R = b["w"].shape[0]
        if b["row_map"] is None:
            pt, ps = jnp.pad(post_t, (0, R - n_p)), jnp.pad(post_s, (0, R - n_p))
        else:
            pt, ps = (jnp.take(x, jnp.asarray(b["row_map"]), axis=0) for x in (post_t, post_s))
        out.append(np.asarray(jops.stdp_update(
            jnp.asarray(b["w"]), jnp.asarray(b["m"]), jnp.asarray(b["cols"]), pre_t, pre_s,
            pt, ps, params=STDP, backend=backend, **kw)))
    return out


def _port(n_p, buckets, vecs):
    plan = stdp_step_plan([b["m"] for b in buckets], [b["row_len"] for b in buckets],
                          [b["row_map"] for b in buckets], n_p, "cpu")
    weights = [torch.from_numpy(b["w"].copy()) for b in buckets]
    got = ops.stdp_update_step(
        weights, [torch.from_numpy(b["m"]) for b in buckets],
        [torch.from_numpy(b["cols"]) for b in buckets], *map(torch.from_numpy, vecs),
        plan=plan, params=STDP)
    assert all(g is w for g, w in zip(got, weights))  # in place
    return plan, [w.numpy() for w in weights]


@pytest.mark.parametrize("name", ["padded", "split", "many_buckets", "nan_pre_trace",
                                  "clip_dw0", "neg_zero"])
def test_step_plain_equals_the_reference_per_bucket_bit_for_bit(rng, name):
    n_p, buckets, vecs = _case(rng, name)
    _, got = _port(n_p, buckets, vecs)
    with jax.disable_jit():
        want = _reference(n_p, buckets, vecs)
    changed = 0
    for g, w, b in zip(got, want, buckets):
        np.testing.assert_array_equal(_bits(g), _bits(w))
        np.testing.assert_array_equal(_bits(g)[b["m"] == 0], _bits(b["w"])[b["m"] == 0])
        changed += int((_bits(g) != _bits(b["w"])).sum())
    assert changed > 0
    if name == "nan_pre_trace":
        assert not any(np.isnan(g).any() for g in got)
    if name == "clip_dw0":
        for g, b in zip(got, buckets):
            p = b["m"] > 0
            np.testing.assert_array_equal(g[p], np.clip(b["w"][p], STDP["w_min"], STDP["w_max"]))
    if name == "neg_zero":
        neg = [(_bits(b["w"]) == _bits(-0.0)) for b in buckets]
        assert all((_bits(g)[n & (b["m"] > 0)] == 0).all() for g, n, b in zip(got, neg, buckets))
        assert all((_bits(g)[n & (b["m"] == 0)] == _bits(-0.0)).all()
                   for g, n, b in zip(got, neg, buckets))


def test_step_plain_equals_the_pallas_kernel_in_interpret_mode(rng):
    n_p, buckets, vecs = _case(rng, "interpret")
    _, got = _port(n_p, buckets, vecs)
    want = _reference(n_p, buckets, vecs, backend="pallas_interpret", block_r=8, block_k=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("name", ["padded", "split", "many_buckets"])
def test_plan_lists_the_rows_with_a_plastic_slot(rng, name):
    n_p, buckets, _ = _case(rng, name)
    plan = stdp_step_plan([b["m"] for b in buckets], [b["row_len"] for b in buckets],
                          [b["row_map"] for b in buckets], n_p, "cpu")
    items = plan.items.numpy()
    nd = len(buckets)
    assert plan.shapes == tuple(b["w"].shape for b in buckets)
    assert len(plan.groups) == -(-nd // STEP_MAX_BUCKETS)
    assert plan.groups[0][0] == 0 and plan.groups[-1][1] == len(items)
    start = 0
    for g, (lo, hi) in enumerate(plan.groups):
        assert lo == start
        start = hi
        for b in range(g * STEP_MAX_BUCKETS, min(nd, (g + 1) * STEP_MAX_BUCKETS)):
            mine = items[lo:hi][items[lo:hi, 0] == b - g * STEP_MAX_BUCKETS]
            bk = buckets[b]
            want_rows = np.flatnonzero((bk["m"] > 0).any(axis=1))
            np.testing.assert_array_equal(mine[:, 1], want_rows)
            np.testing.assert_array_equal(mine[:, 2], bk["row_len"][want_rows])
            post = (np.where(want_rows < n_p, want_rows, -1) if bk["row_map"] is None
                    else bk["row_map"][want_rows])
            np.testing.assert_array_equal(mine[:, 3], post)


def test_plan_refuses_what_the_kernel_cannot_read(rng):
    n_p, buckets, _ = _case(rng, "padded")
    m = [b["m"].copy() for b in buckets]
    rl = [b["row_len"] for b in buckets]
    r = int(np.flatnonzero(rl[0] < m[0].shape[1])[0])
    m[0][r, rl[0][r]] = 1.0  # a plastic slot past the row's real slots
    with pytest.raises(ValueError, match="past its row's real slots"):
        stdp_step_plan(m, rl, None, n_p, "cpu")
    rm = np.full(buckets[0]["w"].shape[0], n_p, np.int32)
    with pytest.raises(ValueError, match="row_map"):
        stdp_step_plan([b["m"] for b in buckets], rl, [rm, None, None], n_p, "cpu")


def test_the_cuda_wrapper_refuses_cpu_tensors(rng):
    n_p, buckets, vecs = _case(rng, "padded")
    plan = stdp_step_plan([b["m"] for b in buckets], [b["row_len"] for b in buckets],
                          None, n_p, "cpu")
    t = torch.from_numpy
    with pytest.raises(ValueError, match="CUDA"):
        stdp_mod.stdp_update_step_cuda(
            [t(b["w"]) for b in buckets], [t(b["m"]) for b in buckets],
            [t(b["cols"]) for b in buckets], *map(t, vecs), plan=plan, params=STDP)


# -- the unfused plastic engine against the reference -------------------------

def _drive(d):
    d.parts[0].vtx_state[:, LIF_BIAS] += DRIVE
    d.meta["noise_sigma"] = 0.0
    return d


def _host(st):
    return {key: (np.asarray(st[key]) if key != "weights"
                  else [np.asarray(w) for w in st[key]])
            for key in ("tr_plus", "tr_minus", "hist", "weights")}


@pytest.fixture(scope="module", params=["k1", "max_k"])
def k1_reference(request):
    """The reference's unfused engine, op by op, on the driven net."""
    kw = dict(max_k=4, align_k=4) if request.param == "max_k" else dict(align_k=8)
    jd = _drive(jnet.to_dcsr(jnet.balanced_ei(n=N, stdp=True), k=1))
    jsim = JSimulator(jd, JSimConfig(backend="ref", fused=False, record_raster=True, **kw))
    assert jsim.engine_choice.engine == "unfused"
    with jax.disable_jit():
        st, out = jsim.run(jsim.init_state(), STEPS)
    return dict(kw=kw, raster=np.asarray(out["raster"]), state=_host(st),
                w0=[np.asarray(w) for w in jsim.dev.weights0])


def _counting(monkeypatch):
    calls = {"n": 0}
    fn = dispatch.lookup("stdp_update_step", "ref")

    def counted(*args, **kwargs):
        calls["n"] += 1
        return fn(*args, **kwargs)

    monkeypatch.setitem(dispatch._REGISTRY, ("stdp_update_step", "ref"), counted)
    return calls


def test_unfused_k1_engine_matches_the_reference(k1_reference, monkeypatch):
    calls = _counting(monkeypatch)
    td = _drive(tnet.to_dcsr(tnet.balanced_ei(n=N, stdp=True), k=1))
    sim = Simulator(td, SimConfig(fused=False, record_raster=True, **k1_reference["kw"]),
                    device="cpu")
    assert sim.engine_choice.engine == "unfused"
    if "max_k" in k1_reference["kw"]:
        assert any(not x for x in sim.dev.identity_rows)
    st, out = sim.run(sim.init_state(), STEPS)
    assert calls["n"] == STEPS
    raster = out["raster"].numpy()
    assert raster.sum() > 0
    np.testing.assert_array_equal(raster, k1_reference["raster"])
    got, want = _host(st), k1_reference["state"]
    for key in ("tr_plus", "tr_minus", "hist"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    changed = 0
    for a, b, w0 in zip(got["weights"], want["weights"], k1_reference["w0"]):
        np.testing.assert_array_equal(_bits(a), _bits(b))
        changed += int((a != w0).sum())
    assert changed > 0


K2_REFERENCE = """
import jax
import numpy as np
from jax.sharding import Mesh
from repro.core import block_partition
from repro.snn import SimConfig, network as jnet
from repro.snn.dist_sim import DistSimulator

net = jnet.balanced_ei({n}, stdp=True)
net.vtx_state[:, {bias}] += {drive}
d = jnet.to_dcsr(net, assignment=block_partition(net.n, 2), uniform=True)
d.meta["noise_sigma"] = 0.0
sim = DistSimulator(d, SimConfig(align_k=8, record_raster=True, fused=False),
                    mesh=Mesh(np.array(jax.devices()[:2]), ("parts",)))
assert sim.engine_choice.engine == "unfused", sim.engine_choice
st, o = sim.run(sim.init_state(), {steps})
out = dict(raster=np.asarray(o["raster"]), tr_plus=np.asarray(st["tr_plus"]),
           tr_minus=np.asarray(st["tr_minus"]))
for i, w in enumerate(st["weights"]):
    out[f"w{{i}}"] = np.asarray(w)
np.savez({path!r}, **out)
print("REFERENCE K2 OK")
"""


def test_unfused_k2_engine_matches_the_reference(tmp_path, monkeypatch):
    path = str(tmp_path / "k2.npz")
    out = run_with_devices(K2_REFERENCE.format(n=N, bias=LIF_BIAS, drive=DRIVE, steps=STEPS,
                                               path=path), n_devices=2)
    assert "REFERENCE K2 OK" in out
    with np.load(path) as z:
        ref = {key: z[key] for key in z.files}
    calls = _counting(monkeypatch)
    net = tnet.balanced_ei(n=N, stdp=True)
    net.vtx_state[:, LIF_BIAS] += DRIVE
    td = tnet.to_dcsr(net, assignment=block_partition(N, 2), uniform=True)
    td.meta["noise_sigma"] = 0.0
    sim = DistSimulator(td, SimConfig(align_k=8, record_raster=True, fused=False),
                        devices=["cpu"] * 2)
    assert sim.engine_choice.engine == "unfused"
    st, o = sim.run(sim.init_state(), STEPS)
    assert calls["n"] == 2 * STEPS  # one a partition and step
    raster = o["raster"].numpy()
    assert ref["raster"].sum() > 0
    np.testing.assert_array_equal(raster, ref["raster"])
    # the reference runs compiled: its traces and weights drift by XLA's
    # contractions, within test_torch_dist.py's 1e-4
    for name in ("tr_plus", "tr_minus"):
        np.testing.assert_allclose(np.stack([c[name].numpy() for c in st]), ref[name],
                                   rtol=1e-4, atol=1e-4)
    changed = 0
    for i, w0 in enumerate(sim.stacked.weights):
        got = np.stack([c["weights"][i].numpy() for c in st])
        np.testing.assert_allclose(got, ref[f"w{i}"], rtol=1e-4, atol=1e-4)
        changed += int((got != w0).sum())
    assert changed > 0
