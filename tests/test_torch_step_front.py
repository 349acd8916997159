"""The step front (``ops.step_front``, kernel ``csrc/step_front.cu``) on the
CPU, where it takes its plain version ``ref.step_front_ref``.

  (a) the plain version against the chain it replaces (``step_noise_add``
      or the plain adds, ``lif_step`` or ``fused_pre_exchange``, the two
      column writes, the uint8 history write): bit for bit, signed zeros
      and NaN too, in every mode;
  (b) its LIF and trace part against the JAX package's ``lif_step`` and
      ``fused_pre_exchange`` on the same ``i_tot``: bit for bit against
      ``repro.kernels.ref`` run op by op (``jax.disable_jit()``), and against
      the TPU kernel bodies in interpret mode within rtol=atol=1e-6 for
      ``v`` and the traces (the interpret kernel is compiled, and XLA
      contracts its multiply-adds), spikes and refractory counters exact, as
      ``tests/test_torch_kernels.py`` and ``tests/test_torch_dist.py`` hold
      those ops;
  (c) 50 steps of each engine that takes the front, through the front and
      through the old chain (``make_core_step(front=False)``, as
      ``chip_smoke.py`` builds it): raster, ``vtx_state``, ring, ``hist``,
      traces and weights identical;
  (d) a session raster against the JAX ``Session``'s, with the reference's
      noise injected through the ``_noise_fn`` seam and with no noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.snn import Session as JSession
from repro.snn import SimConfig as JSimConfig
from repro.snn import monitors as jmon
from repro.snn import network as jnet
from repro_torch.core import block_partition
from repro_torch.kernels import ops, ref
from repro_torch.kernels import step_front as front_mod
from repro_torch.snn import RasterMonitor, Session, SimConfig, Simulator
from repro_torch.snn import network as tnet
from repro_torch.snn.neurons import LIF_BIAS, LIF_REF, LIF_V
from repro_torch.snn.simulator import FRONT_ENGINES

LIF_PARAMS = dict(
    dt=0.1, tau_m=10.0, v_rest=-65.0, v_reset=-65.0, v_thresh=-50.0,
    t_ref=2.0, r_m=1.0,
)
TAUS = (20.0, 15.0)
SEED, SIGMA = 42, 0.8
STEPS = 50


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _case(rng, n):
    """A vtx_state of width 4 (v, refrac, bias, a fourth column the front
    must leave alone), a ring slot with signed zeros and a NaN, ids past
    2^32 and repeated, both traces with signed zeros, and a history row."""
    vtx = np.empty((n, 4), np.float32)
    vtx[:, LIF_V] = -66.0 + 20.0 * rng.random(n)
    vtx[:, LIF_REF] = rng.integers(0, 3, n)
    vtx[:, LIF_BIAS] = rng.normal(0.0, 5.0, n)
    vtx[:, 3] = rng.normal(size=n)
    slot = rng.normal(0.0, 10.0, n).astype(np.float32)
    slot[::7] = -0.0
    slot[3::7] = 0.0
    slot[min(5, n - 1)] = np.nan
    ids = rng.permutation(n).astype(np.int64)
    ids[::5] += 2**32 + 17
    ids[1::11] = ids[0]
    tp, tm = rng.random(n).astype(np.float32), rng.random(n).astype(np.float32)
    tp[::4], tm[1::4] = -0.0, -0.0
    hist = rng.integers(0, 2, n).astype(np.uint8)
    return [torch.from_numpy(a) for a in (vtx, slot, ids, tp, tm, hist)]


def _old_chain(vtx, slot, ids, tp, tm, hist_row, *, t, draw, bias, traces):
    """What the engines ran before the front, on copies of the operands."""
    b = vtx[:, LIF_BIAS] if bias else None
    if draw:
        i_in = ref.step_noise_add_ref(slot, ids, SEED, t, SIGMA, b)
    else:
        i_in = slot.clone()
        if b is not None:
            i_in += b
    v, refrac = vtx[:, LIF_V].contiguous(), vtx[:, LIF_REF].contiguous()
    if traces:
        v2, r2, s, tp2, tm2 = ops.fused_pre_exchange(v, refrac, i_in, tp, tm,
                                                     params=LIF_PARAMS, taus=TAUS)
    else:
        v2, r2, s = ops.lif_step(v, refrac, i_in, params=LIF_PARAMS)
    vtx[:, LIF_V] = v2
    vtx[:, LIF_REF] = r2
    hist_row[:] = s.to(torch.uint8)
    return (s, tp2, tm2) if traces else (s,), i_in


# -- (a) the plain version against the chain it replaces ---------------------------

@pytest.mark.parametrize("traces", [False, True])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("draw", [False, True])
@pytest.mark.parametrize("n", [1, 37, 1000])
def test_front_plain_is_the_old_chain_bit_for_bit(rng, n, draw, bias, traces):
    vtx, slot, ids, tp, tm, hist = _case(rng, n)
    for t in (0, 7, 2**31 + 3):
        vtx_o, hist_o = vtx.clone(), hist.clone()
        want, _ = _old_chain(vtx_o, slot, ids, tp, tm, hist_o, t=t, draw=draw, bias=bias,
                             traces=traces)
        vtx_n, hist_n, slot_n = vtx.clone(), hist.clone(), slot.clone()
        got = ops.step_front(
            vtx_n, slot_n, ids, seed=SEED, t=t, sigma=SIGMA, draw=draw, bias=bias,
            hist_row=hist_n, tr_plus=tp if traces else None, tr_minus=tm if traces else None,
            params=LIF_PARAMS, taus=TAUS if traces else None,
        )
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(_bits(a), _bits(b))
        assert torch.equal(_bits(vtx_n), _bits(vtx_o))  # the fourth column untouched too
        assert torch.equal(hist_n, hist_o)
        assert torch.equal(_bits(slot_n), _bits(slot))  # the slot is read, not written
    if n > 5:  # the NaN of the slot reaches v unless the row is refractory
        assert torch.isnan(vtx_n[5, LIF_V]) or vtx[5, LIF_REF] > 0


def test_front_without_a_history_row_writes_none(rng):
    vtx, slot, ids, *_ = _case(rng, 64)
    got = ops.step_front(vtx.clone(), slot, ids, seed=SEED, t=3, sigma=SIGMA, draw=True,
                         bias=True, hist_row=None, params=LIF_PARAMS)
    hist = torch.zeros(64, dtype=torch.uint8)
    want, _ = _old_chain(vtx.clone(), slot, ids, None, None, hist, t=3, draw=True, bias=True,
                         traces=False)
    assert torch.equal(got[0], want[0])


def test_front_kernel_refuses_cpu_tensors():
    """On the CPU the op takes the plain version because the tensors lie
    there; the kernel's wrapper itself refuses them: there is no fallback."""
    vtx = torch.zeros((8, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        front_mod.step_front_cuda(vtx, torch.zeros(8), torch.arange(8), seed=1, t=0, sigma=1.0,
                                  draw=True, bias=True, hist_row=None, params=LIF_PARAMS)


# -- (b) the LIF and trace part against the JAX package ------------------------------

@pytest.mark.parametrize("traces", [False, True])
@pytest.mark.parametrize("n", [1, 37, 1000])
def test_front_lif_and_traces_match_the_jax_ops(rng, n, traces):
    vtx, slot, ids, tp, tm, hist = _case(rng, n)
    slot = torch.nan_to_num(slot)  # the JAX interpret kernel is held within a tolerance
    vtx_n = vtx.clone()
    got = ops.step_front(vtx_n, slot, ids, seed=SEED, t=11, sigma=SIGMA, draw=True, bias=True,
                         hist_row=hist, tr_plus=tp if traces else None,
                         tr_minus=tm if traces else None, params=LIF_PARAMS,
                         taus=TAUS if traces else None)
    i_tot = ref.step_noise_add_ref(slot, ids, SEED, 11, SIGMA, vtx[:, LIF_BIAS])
    args = [jnp.asarray(x.numpy()) for x in (vtx[:, LIF_V].contiguous(),
                                              vtx[:, LIF_REF].contiguous(), i_tot)]
    targs = [jnp.asarray(x.numpy()) for x in (tp, tm)] if traces else []
    port = [vtx_n[:, LIF_V], vtx_n[:, LIF_REF], *got]
    with jax.disable_jit():  # op by op: the plain version's rounding, exactly
        if traces:
            oracle = jref.fused_pre_exchange_ref(*args, *targs, params=LIF_PARAMS, taus=TAUS)
        else:
            oracle = jref.lif_step_ref(*args, **LIF_PARAMS)
    for a, b in zip(port, oracle):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if traces:
        interp = jops.fused_pre_exchange(*args, *targs, params=LIF_PARAMS, taus=TAUS,
                                         backend="pallas_interpret")
    else:
        interp = jops.lif_step(*args, params=LIF_PARAMS, backend="pallas_interpret")
    for i, (a, b) in enumerate(zip(port, interp)):
        if i in (1, 2):  # refrac and spikes exact
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:  # v and the traces within rtol=atol=1e-6
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(oracle[2]).astype(np.uint8))


# -- (c) the engines through the front and through the old chain -------------------

def _plain_net(mod, k):
    net = mod.spatial_random(240, avg_degree=10, seed=4)
    net.vtx_state[:, 2] += 50.0  # drive real activity through the ring
    return mod.to_dcsr(net, assignment=block_partition(net.n, k), uniform=True)


def _plastic_net(k):
    net = tnet.balanced_ei(160, stdp=True, seed=7, delay_steps=5)
    net.vtx_state[:, 2] += 6.0  # drive real activity through STDP
    return tnet.to_dcsr(net, assignment=block_partition(net.n, k), uniform=True)


def _state_equal(a, b):
    for key in ("vtx_state", "ring", "hist", "tr_plus", "tr_minus"):
        assert torch.equal(_bits(a[key]), _bits(b[key])), key
    for wa, wb in zip(a["weights"], b["weights"]):
        assert torch.equal(wa, wb)


@pytest.mark.parametrize("engine,overlap", [
    ("fused_event", "auto"),
    ("fused_split", "off"), ("fused_split", "local"),
    ("fused_split_event", "off"), ("fused_split_event", "double_buffer"),
    ("fused_split_plastic", "double_buffer"), ("fused_split_plastic", "off"),
])
def test_engines_through_the_front_equal_the_old_chain(engine, overlap):
    gather = "event" if engine.endswith("event") else "dense"
    cfg = SimConfig(fused=True, gather=gather, overlap=overlap)
    if engine == "fused_event":
        sim = Simulator(_plain_net(tnet, 1), cfg, device="cpu")
        old = sim._make_step(gather, front=False)
    else:
        d = _plastic_net(4) if engine.endswith("plastic") else _plain_net(tnet, 4)
        sim = Session(d, cfg, engine="spmd", devices=["cpu"] * 4).simulator
        old = sim._make_steps(gather, front=False)
    assert sim.engine_choice.engine == engine
    assert engine in FRONT_ENGINES
    state = sim.init_state()
    st_new, out_new = sim.run(state, STEPS, record_raster=True)
    front = sim._step
    sim._step = old
    st_old, out_old = sim.run(state, STEPS, record_raster=True)
    sim._step = front
    assert int(out_new["raster"].sum()) > 0
    assert torch.equal(out_new["raster"], out_old["raster"])
    if engine == "fused_event":  # one carry at k = 1, a list of k at k > 1
        st_new, st_old = [st_new], [st_old]
    for a, b in zip(st_new, st_old):
        _state_equal(a, b)
    if engine.endswith("plastic"):
        w0 = sim.devs[0].weights0
        assert any(not torch.equal(a, b) for a, b in zip(st_new[0]["weights"], w0))


def test_front_engines_launch_no_old_chain_op(monkeypatch):
    """The engines that take the front reach none of the ops it replaced."""
    calls = []
    for name in ("step_noise_add", "lif_step", "fused_pre_exchange"):
        monkeypatch.setattr(ops, name, lambda *a, _n=name, **k: calls.append(_n))
    sim = Simulator(_plain_net(tnet, 1), SimConfig(fused=True, gather="event"), device="cpu")
    sim.run(sim.init_state(), 5)
    for d, cfg in ((_plain_net(tnet, 4), {}), (_plastic_net(4), dict(overlap="double_buffer"))):
        ses = Session(d, SimConfig(fused=True, **cfg), engine="spmd", devices=["cpu"] * 4)
        ses.run(5)
    assert calls == []


# -- (d) session rasters against the JAX Session ------------------------------------

def _reference_noise(n, sigma):
    key = jax.random.PRNGKey(SEED)
    draw = jax.jit(
        lambda t: sigma * jax.random.normal(jax.random.fold_in(key, t), (n,), jnp.float32)
    )
    return lambda t: np.asarray(draw(t))


@pytest.fixture(scope="module")
def jax_rasters():
    out = {}
    for noise in (True, False):
        jd = _plain_net(jnet, 1)
        if not noise:
            jd.meta["noise_sigma"] = 0.0
        mon = jmon.RasterMonitor()
        JSession(jd, JSimConfig(align_k=32)).run(2 * STEPS, monitors=[mon])
        out[noise] = (mon.raster, float(jd.meta["noise_sigma"]))
    return out


@pytest.mark.parametrize("noise", [True, False])
@pytest.mark.parametrize("k", [1, 4])
def test_front_sessions_match_the_jax_session(jax_rasters, k, noise):
    want, sigma = jax_rasters[noise]
    td = _plain_net(tnet, k)
    td.meta["noise_sigma"] = sigma
    kw = dict(engine="spmd", devices=["cpu"] * 4) if k > 1 else dict(device="cpu")
    if noise:
        kw["_noise_fn"] = _reference_noise(td.n, sigma)
    ses = Session(td, SimConfig(align_k=32, fused=True, gather="event"), **kw)
    assert ses.engine_choice.engine == ("fused_split_event" if k > 1 else "fused_event")
    mon = RasterMonitor()
    ses.run(2 * STEPS, monitors=[mon])
    assert want.sum() > STEPS
    np.testing.assert_array_equal(mon.raster[:, np.argsort(ses.permanent_ids)], want)
