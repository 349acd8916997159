"""The compiled chunk's contract on the CPU: ``t`` lives on the device.

On the card ``Simulator.run`` and ``DistSimulator.run`` replay one CUDA
graph per step engine, chunk length and recordings, at any ``t``
(``snn/simulator.py:ChunkGraphs``); the CPU runs the same step code
uncaptured, so these tests exercise exactly the code the card captures:

* the carry's ``t`` is a 0-d int64 tensor on the run's device, and every
  op of a step reads ``t`` and the ring rows it selects there;
* runs in chunks of 1, 7 and 128 steps, and in chunks whose starts take
  every phase ``t0 % D`` of the ring, give the one long run's raster,
  ``vtx_state``, ring, hist, traces and weights bit for bit, on every
  engine (k = 1, and k = 2 and 4 on ``devices=["cpu"] * k``);
* the plain versions of ``step_noise_add``, ``step_front`` and
  ``event_post_exchange`` with ``t`` and the slots as tensors equal their
  int forms bit for bit;
* a run's returned state and outputs are not changed by a later run;
* ``Session.t``, ``save``/``restore`` and ``Session(path)`` round-trip a
  device ``t``.

The card's half (graphs against ``_graphs=False``, replays at several
``t0``, one capture a key, no host sync) is in ``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import block_partition
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.event_step import EventPlan, event_post_exchange_plain
from repro_torch.snn import Session, SimConfig, Simulator, balanced_ei, microcircuit, to_dcsr
from repro_torch.snn.dist_sim import DistSimulator
from repro_torch.snn.simulator import graph_failure, graph_mode

LIF_PARAMS = dict(
    dt=0.1, tau_m=10.0, v_rest=-65.0, v_reset=-65.0, v_thresh=-50.0,
    t_ref=2.0, r_m=1.0,
)
TAUS = (20.0, 15.0)
STEPS = 240


def _net(kind: str, k: int):
    net = (microcircuit(scale=0.01, seed=0) if kind == "mc"
           else balanced_ei(200, stdp=True, seed=7, delay_steps=5))
    if k == 1:
        return to_dcsr(net, k=1)
    return to_dcsr(net, assignment=block_partition(net.n, k), uniform=True)


# (net, k, SimConfig fields, the engine it must take)
ENGINES = {
    "fused_event": ("mc", 1, dict(fused=True, gather="event"), "fused_event"),
    "fused": ("mc", 1, dict(fused=True, gather="dense"), "fused"),
    "unfused": ("mc", 1, dict(fused=False), "unfused"),
    "fused_plastic": ("ei", 1, dict(fused=True), "fused_plastic"),
    "k2_split_event_double_buffer": (
        "mc", 2, dict(fused=True, gather="event", overlap="double_buffer"), "fused_split_event"),
    "k4_split_local": ("mc", 4, dict(fused=True, gather="dense", overlap="local"), "fused_split"),
    "k4_split_event": ("mc", 4, dict(fused=True, gather="event"), "fused_split_event"),
    "k2_split_plastic_double_buffer": (
        "ei", 2, dict(fused=True, overlap="double_buffer"), "fused_split_plastic"),
    "k4_unfused": ("mc", 4, dict(fused=False), "unfused"),
}


def _sim(name: str):
    kind, k, fields, engine = ENGINES[name]
    cfg = SimConfig(align_k=32, **fields)
    d = _net(kind, k)
    sim = (Simulator(d, cfg, device="cpu") if k == 1
           else DistSimulator(d, cfg, devices=["cpu"] * k))
    assert sim.engine_choice.engine == engine
    assert sim.graph_mode == "uncaptured: the CPU"
    return sim


def _carries(state):
    return [state] if isinstance(state, dict) else list(state)


def _run(sim, schedule):
    st, rasters = sim.init_state(), []
    for c in schedule:
        st, out = sim.run(st, c, record_raster=True)
        rasters.append(out["raster"])
    return st, torch.cat(rasters)


def _assert_same_state(a, b):
    for ca, cb in zip(_carries(a), _carries(b)):
        assert ca["t"].dtype == torch.int64 and ca["t"].dim() == 0
        assert torch.equal(ca["t"], cb["t"])
        for key in ("vtx_state", "ring", "hist", "tr_plus", "tr_minus"):
            # bit for bit, signed zeros too
            assert torch.equal(ca[key].view(torch.uint8), cb[key].view(torch.uint8)), key
        for wa, wb in zip(ca["weights"], cb["weights"]):
            assert torch.equal(wa.view(torch.uint8), wb.view(torch.uint8))


@pytest.fixture(scope="module")
def long_runs():
    """Per engine its simulator and the one long run of ``STEPS`` steps."""
    cache = {}

    def get(name):
        if name not in cache:
            sim = _sim(name)
            cache[name] = (sim, *_run(sim, [STEPS]))
        return cache[name]

    return get


def _schedules(d_ring: int):
    phase = d_ring + 1  # the chunks' starts 0, D+1, 2(D+1), ... take every phase mod D
    schedules = {
        "ones": [1] * 16 + [STEPS - 16],
        "sevens": [7] * (STEPS // 7) + [STEPS % 7],
        "128": [128, STEPS - 128],
        "every_phase": [phase] * d_ring + [STEPS - phase * d_ring],
    }
    return {k: [c for c in v if c] for k, v in schedules.items()}


@pytest.mark.parametrize("schedule", ["ones", "sevens", "128", "every_phase"])
@pytest.mark.parametrize("name", list(ENGINES))
def test_chunked_runs_equal_one_long_run(long_runs, name, schedule):
    sim, st_long, raster_long = long_runs(name)
    chunks = _schedules(sim.d_ring)[schedule]
    assert sum(chunks) == STEPS and all(c > 0 for c in chunks)
    starts = np.cumsum([0] + chunks[:-1])
    if schedule == "every_phase":
        assert set(starts % sim.d_ring) == set(range(sim.d_ring))
    assert int(raster_long.sum()) > 0
    st, raster = _run(sim, chunks)
    assert torch.equal(raster, raster_long)
    _assert_same_state(st, st_long)
    assert all(int(c["t"]) == STEPS for c in _carries(st))


@pytest.mark.parametrize("name", ["fused_event", "k4_split_local", "fused_plastic"])
def test_the_carry_t_is_a_device_tensor(name):
    sim = _sim(name)
    st0 = sim.init_state(t0=11)
    for c in _carries(st0):
        assert torch.is_tensor(c["t"]) and c["t"].dtype == torch.int64 and c["t"].dim() == 0
        assert c["t"].device.type == "cpu" and int(c["t"]) == 11
    st, _ = sim.run(st0, 5)
    assert all(int(c["t"]) == 16 and c["t"].dim() == 0 for c in _carries(st))
    # the caller's t is not advanced, and an int t is taken too
    assert all(int(c["t"]) == 11 for c in _carries(st0))
    as_int = [dict(c, t=11) for c in _carries(st0)]
    st_i, _ = sim.run(as_int[0] if len(as_int) == 1 else as_int, 5)
    _assert_same_state(st_i, st)


@pytest.mark.parametrize("name", ["fused", "k2_split_plastic_double_buffer"])
def test_a_later_run_changes_no_returned_state_or_output(name):
    sim = _sim(name)
    st1, out1 = sim.run(sim.init_state(), 20, record_raster=True, record_v=True)
    keep_st = [{k: (tuple(w.clone() for w in v) if k == "weights" else v.clone())
                for k, v in c.items()} for c in _carries(st1)]
    keep_out = {k: v.clone() for k, v in out1.items()}
    sim.run(st1, 20, record_raster=True, record_v=True)
    sim.run(sim.init_state(), 20, record_raster=True, record_v=True)
    _assert_same_state(st1, keep_st[0] if len(keep_st) == 1 else keep_st)
    for k, v in keep_out.items():
        assert torch.equal(out1[k], v), k


# -- the plain versions: t and the slots as tensors equal the int forms ------

@pytest.mark.parametrize("t", [0, 7, 999, 2**31 + 3, 2**32 + 5])
def test_plain_noise_add_takes_a_tensor_t(t):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=257).astype(np.float32))
    ids = torch.from_numpy(rng.permutation(257).astype(np.int64) + (2**32 if t % 2 else 0))
    bias = torch.from_numpy(rng.normal(size=(257, 4)).astype(np.float32))[:, 2]
    for b in (None, bias):
        want = ref.step_noise_add_ref(x, ids, 42, t, 0.8, b)
        got = ref.step_noise_add_ref(x, ids, 42, torch.tensor(t), 0.8, b)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        via_op = ops.step_noise_add(x, ids, 42, torch.tensor(t), 0.8, b)
        assert torch.equal(via_op.view(torch.int32), want.view(torch.int32))
    k_int = ref.step_key_ref(42, t)
    k_ten = ref.step_key_ref(42, torch.tensor(t))
    assert all(torch.is_tensor(k) and int(k) == i for k, i in zip(k_ten, k_int))


@pytest.mark.parametrize("traces", [False, True])
@pytest.mark.parametrize("t", [0, 3, 4, 12, 2**31 + 3])
def test_plain_step_front_picks_the_ring_and_hist_rows_of_t(t, traces):
    """The ``(D, n)`` ring and history with a tensor ``t`` against the row
    ``t % D`` of each with the int ``t``: spikes, traces, ``vtx_state`` and
    the whole history bit for bit; the other history rows untouched."""
    rng = np.random.default_rng(t % 97)
    D, n = 5, 300
    vtx = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))
    vtx[:, 0] = torch.from_numpy((-66.0 + 20.0 * rng.random(n)).astype(np.float32))
    vtx[:, 1] = torch.from_numpy(rng.integers(0, 3, n).astype(np.float32))
    ring = torch.from_numpy(rng.normal(0.0, 10.0, (D, n)).astype(np.float32))
    hist = torch.from_numpy(rng.integers(0, 2, (D, n)).astype(np.uint8))
    ids = torch.arange(n, dtype=torch.int64) * 3
    tp, tm = (torch.from_numpy(rng.random(n).astype(np.float32)) for _ in range(2))
    kw = dict(seed=42, sigma=0.8, draw=True, bias=True, params=LIF_PARAMS,
              tr_plus=tp if traces else None, tr_minus=tm if traces else None,
              taus=TAUS if traces else None)
    vtx_i, hist_i = vtx.clone(), hist.clone()
    want = ref.step_front_ref(vtx_i, ring[t % D], ids, t=t, hist_row=hist_i[t % D], **kw)
    vtx_t, hist_t = vtx.clone(), hist.clone()
    got = ops.step_front(vtx_t, ring, ids, t=torch.tensor(t), hist_row=hist_t, **kw)
    assert len(got) == len(want) == (3 if traces else 1)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(vtx_t.view(torch.int32), vtx_i.view(torch.int32))
    assert torch.equal(hist_t, hist_i)
    others = [r for r in range(D) if r != t % D]
    assert torch.equal(hist_t[others], hist[others])


@pytest.mark.parametrize("clear", [True, False])
@pytest.mark.parametrize("t", [0, 6, 13, 2**31 + 3])
def test_plain_event_step_takes_t_and_the_delays(t, clear):
    """The event step's device form (``slot`` the step's ``t``,
    ``write_slots`` the delays, ``clear``) against its int form (``t % D``
    or None, ``(t + d) % D``): ring and flags bit for bit."""
    rng = np.random.default_rng(t % 89)
    D, n_p, n, R, delays = 7, 40, 60, 48, (1, 3, 6, 6)
    cols = [rng.integers(0, n, (R, 16)).astype(np.int32) for _ in delays]
    valid = [rng.random((R, 16)) < 0.7 for _ in delays]
    weights = [torch.from_numpy(np.where(v, rng.normal(size=v.shape), 0.0).astype(np.float32))
               for v in valid]
    plan = EventPlan.build(cols, valid, n, cap=8, device="cpu", block_r=16)
    cols = [torch.from_numpy(c) for c in cols]
    act = torch.from_numpy((rng.random(n) < 0.08).astype(np.float32))
    ring = torch.from_numpy(rng.normal(size=(D, n_p)).astype(np.float32))
    ring[t % D, ::5] = -0.0
    want, got = ring.clone(), ring.clone()
    flags_i = event_post_exchange_plain(act, want, t % D if clear else None,
                                        [(t + d) % D for d in delays], plan, cols, weights)
    flags_t = ops.event_post_exchange(act, got, torch.tensor(t), delays, plan, cols, weights,
                                      clear=clear)
    assert torch.equal(flags_t, flags_i)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_event_step_refuses_int_slots_outside_the_ring():
    plan = EventPlan.build([np.zeros((8, 4), np.int32)], [np.ones((8, 4), bool)], 8, 4, "cpu")
    ring = torch.zeros((3, 8))
    with pytest.raises(ValueError, match="outside"):
        event_post_exchange_plain(torch.zeros(8), ring, 3, [0], plan,
                                  [torch.zeros((8, 4), dtype=torch.int32)], [torch.zeros((8, 4))])


# -- sessions and snapshots with a device t ------------------------------------

def test_session_round_trips_a_device_t(tmp_path):
    d = _net("mc", 1)
    cfg = SimConfig(align_k=32, fused=True)
    ses = Session(d, cfg, device="cpu")
    assert ses.t == 0 and ses.describe()["graphs"] == dict(mode="uncaptured: the CPU",
                                                           captured=[])
    ses.run(37, chunk_size=16)
    assert ses.t == 37 and isinstance(ses.t, int)
    t = ses.state["t"]
    assert torch.is_tensor(t) and t.dtype == torch.int64 and t.dim() == 0 and int(t) == 37
    ses.save(str(tmp_path / "snap"))
    live = ses.run(23).spike_count
    for back in (Session.restore(str(tmp_path / "snap"), cfg=cfg, device="cpu"),
                 Session(str(tmp_path / "snap"), cfg, device="cpu")):
        assert back.t == 37 and int(back.state["t"]) == 37 and back.state["t"].dim() == 0
        assert np.array_equal(back.run(23, chunk_size=5).spike_count, live)
        assert back.t == 60
    st = ses.simulator.load_runtime(ses.simulator.init_state(9), ses.simulator.runtime_state(
        ses.state))
    assert int(st["t"]) == 9 and st["t"].dim() == 0


def test_graph_mode_says_why_a_run_is_uncaptured():
    assert graph_mode("cuda", True, False) == "cuda_graph"
    assert graph_mode("cpu", True, False) == "uncaptured: the CPU"
    assert graph_mode("cuda", False, False) == "uncaptured: _graphs=False"
    assert graph_mode("cuda", True, True) == "uncaptured: the _noise_fn seam"
    assert graph_mode("cuda", True, False, cards=2) == (
        "uncaptured: partitions on more than one card")
    sim = Simulator(_net("mc", 1), SimConfig(align_k=32), device="cpu",
                    _noise_fn=lambda t: np.zeros(1, np.float32))
    assert sim.graph_mode == "uncaptured: the CPU"


def test_a_capture_failure_names_the_line_that_broke_it():
    try:
        _build.step_tensor(-1, torch.device("cpu"))
    except ValueError as err:
        failure = graph_failure("fused_event x 128", err)
    assert isinstance(failure, RuntimeError)
    msg = str(failure)
    assert "fused_event x 128" in msg and "_build.py:" in msg and "must be >= 0" in msg
