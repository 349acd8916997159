"""The heavy-row split's step op (``ops.segment_gather_ring``) on the CPU.

* Its plain version against the composition it replaced, bit for bit (per
  bucket ``ref.spike_gather_segment_ref``, or ``spike_gather_ref`` for
  unsplit rows, then the ring add at ``(t + d) % D``), and against the
  reference's ``spike_gather_ref`` + ``jax.ops.segment_sum`` +
  ``ring.at[(t + d) % D].add`` (``repro/snn/simulator.py:644-655``): f32
  and bf16 weights, ``n_p = 1`` (the padding rows in row 0's range), an
  unsplit bucket beside depth-1 and deeper ones, 15 buckets with distinct
  delays.
* The upload's tile table covers every virtual row once, in order.
* The unfused split step makes one call of the op a step and no
  ``spike_gather``; the CUDA wrapper refuses CPU tensors.

Torch runs at one thread here (module fixture).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import dispatch, ops, ref
from repro_torch.kernels import segment_gather as seg_mod
from repro_torch.snn import SimConfig, Simulator, balanced_ei, to_dcsr
from repro_torch.snn.simulator import split_row_ptr


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bucket(rng, n, n_p, K, depth, pad=3):
    """A split bucket as the ELL builder lays it out: row r owns 1..depth
    contiguous virtual rows (``depth`` 0: an unsplit bucket of n_p + pad
    rows), real slots first, ``pad`` empty rows after, which ``row_map``
    sends to row 0."""
    if depth == 0:
        counts, row_map = None, None
        R = n_p + pad
    else:
        counts = rng.integers(1, depth + 1, n_p)
        counts[rng.integers(0, n_p)] = depth
        r_v = int(counts.sum())
        R = r_v + pad
        row_map = np.zeros(R, np.int32)
        row_map[:r_v] = np.repeat(np.arange(n_p, dtype=np.int32), counts)
    lens = rng.integers(0, K + 1, R)
    if depth:
        lens[R - pad:] = 0
    else:
        lens[n_p:] = 0
    live = np.arange(K)[None, :] < lens[:, None]
    cols = np.where(live, rng.integers(0, n, (R, K)), 0).astype(np.int32)
    w = np.where(live, rng.normal(size=(R, K)), 0.0).astype(np.float32)
    rp = None if depth == 0 else split_row_ptr(row_map, n_p)
    return cols, w, lens.astype(np.int32), row_map, rp


CASES = {
    "f32": (400, 60, [(16, 3), (8, 0), (12, 1)], [3, 5, 9], 16, "float32"),
    "bf16": (400, 60, [(16, 3), (8, 0), (12, 1)], [3, 5, 9], 16, "bfloat16"),
    "n_p=1": (30, 1, [(8, 4), (4, 1)], [1, 2], 4, "float32"),
    "15 buckets": (300, 40, [(8, 1 + i % 4) if i % 5 else (8, 0) for i in range(15)],
                   list(range(1, 16)), 15, "float32"),
    "same slot": (200, 30, [(8, 2), (8, 3)], [2, 2 + 7], 7, "float32"),
}


def _case(name, rng):
    n, n_p, specs, delays, D, dtype = CASES[name]
    buckets = [_bucket(rng, n, n_p, K, depth) for K, depth in specs]
    act = (rng.random(n) < 0.3).astype(np.float32)
    act[rng.random(n) < 0.1] = 0.5
    ring = rng.normal(size=(D, n_p)).astype(np.float32)
    w = [torch.from_numpy(b[1]).to(getattr(torch, dtype)) for b in buckets]
    return n_p, delays, D, buckets, act, ring, w


@pytest.mark.parametrize("t", [0, 37])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_op_equals_the_composition_it_replaced(rng, name, t):
    n_p, delays, D, buckets, act, ring0, w = _case(name, rng)
    cols = [torch.from_numpy(b[0]) for b in buckets]
    row_len = [torch.from_numpy(b[2]) for b in buckets]
    row_ptr = [None if b[4] is None else torch.from_numpy(b[4]) for b in buckets]
    plan = seg_mod.segment_plan([b[4] for b in buckets], [c.shape[1] for c in cols], n_p, "cpu")
    a = torch.from_numpy(act)
    t_dev = torch.tensor(t, dtype=torch.int64)
    got = ops.segment_gather_ring(a, torch.from_numpy(ring0.copy()), t_dev, delays, plan, cols,
                                  w, row_len, row_ptr, reduce=dispatch.panel_reduce(w))
    # the composition the op replaced: a bucket at a time, then the ring add
    want = torch.from_numpy(ring0.copy())
    for b, (c, wb, rp, d) in enumerate(zip(cols, w, row_ptr, delays)):
        cur = (ref.spike_gather_ref(a, c, wb)[:n_p] if rp is None
               else ref.spike_gather_segment_ref(a, c, wb, rp, depth=plan.depth[b]))
        row = torch.remainder(t_dev + d, D).view(1)
        want.index_put_((row,), cur[None], accumulate=True)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the int step gives the same ring
    assert torch.equal(ops.segment_gather_ring(a, torch.from_numpy(ring0.copy()), t, delays, plan,
                                               cols, w, row_len, row_ptr), got)
    # the reference: its gather, segment_sum over row_map, ring.at[].add
    jring = jnp.asarray(ring0)
    for (c, _, _, row_map, rp), wb, d in zip(buckets, w, delays):
        cur = jref.spike_gather_ref(jnp.asarray(act), jnp.asarray(c),
                                    jnp.asarray(wb.float().numpy()))
        if rp is None:
            cur = cur[:n_p]
        else:
            cur = jax.ops.segment_sum(cur, jnp.asarray(row_map), num_segments=n_p)
        jring = jring.at[(t + d) % D].add(cur)
    np.testing.assert_allclose(got.numpy(), np.asarray(jring), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", range(6))
def test_tiles_cover_every_virtual_row_once_in_order(seed):
    rng = np.random.default_rng(seed)
    n_p = int(rng.integers(1, 300))
    ptrs, widths = [], []
    for _ in range(int(rng.integers(1, 6))):
        widths.append(int(rng.choice([4, 32, 64, 129, 512, 1024, 1100, 3000])))
        if rng.random() < 0.3:
            ptrs.append(None)
        else:
            counts = rng.integers(0, 6, n_p)
            ptrs.append(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    plan = seg_mod.segment_plan(ptrs, widths, n_p, "cpu")
    tiles = plan.tiles.numpy()
    assert tiles.dtype == np.int32 and tiles.shape[1] == 3
    assert plan.rows == tuple(n_p if p is None else int(p[-1]) for p in ptrs)
    for b, (K, rows) in enumerate(zip(widths, plan.rows)):
        mine = tiles[tiles[:, 0] == b]
        covered = np.concatenate([np.arange(r0, r0 + nr) for _, r0, nr in mine] or [[]])
        assert np.array_equal(covered, np.arange(rows))  # each once, ascending
        for _, r0, nr in mine:
            # at most the tile size, or one row wider than it
            assert nr >= 1 and nr * K <= plan.tile_slots
            assert nr * K <= seg_mod.TILE_SLOTS or nr == 1
    # bucket by bucket, in order
    assert np.all(np.diff(tiles[:, 0]) >= 0)


def test_split_step_makes_one_segment_call_a_step(monkeypatch):
    """The unfused split step (plastic, 13 of 15 buckets split) calls the
    op once a step for every bucket and ``spike_gather`` never."""
    calls = {"segment_gather_ring": 0, "spike_gather": 0}
    for op in calls:
        fn = dispatch.lookup(op, "ref")

        def counted(*args, _fn=fn, _op=op, **kwargs):
            calls[_op] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setitem(dispatch._REGISTRY, (op, "ref"), counted)
    d = to_dcsr(balanced_ei(n=200, stdp=True), k=1)
    sim = Simulator(d, SimConfig(max_k=4, align_k=4), device="cpu")
    assert sim.engine_choice.engine == "unfused" and sim.dev.segment is not None
    assert 1 <= sum(not x for x in sim.dev.identity_rows) < len(sim.dev.cols)
    sim.run(sim.init_state(), 5)
    assert calls == {"segment_gather_ring": 5, "spike_gather": 0}


def test_the_cuda_wrapper_refuses_cpu_tensors():
    plan = seg_mod.segment_plan([np.array([0, 1], np.int32)], [4], 1, "cpu")
    args = (torch.zeros(8), torch.zeros((2, 1)), 0, [1], plan,
            [torch.zeros((1, 4), dtype=torch.int32)], [torch.zeros((1, 4))])
    with pytest.raises(ValueError, match="CUDA"):
        seg_mod.segment_gather_ring_cuda(*args)
