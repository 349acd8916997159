"""The port's own fault harness (``repro_torch.testing.fault_plans``) on the
CPU.

* Harness parity with the reference's ``repro.testing.faults``: the same
  plan and the same ``(site, path)`` hits give the same ``fired`` log, the
  same exceptions and byte-identical torn and bit-flipped files; the same
  error texts; the same neuron and value poisoned by ``nan`` and ``storm``
  at k = 1 and on a k = 3 spmd carry, written into the carry in place.
* The reference's own scenarios (``tests/test_faults.py``) against the
  port's io stack with the port's plans: hit windows, healed transient and
  torn writes, exhausted retries, bit rot on read, the three crash windows
  of ``atomic_dir``, truncation sweeps, the async writer, ``no_faults`` and
  the chaos plans, which over ``save_binary``, ``Session.save`` /
  ``restore``, ``run(checkpoint_every=...)`` and ``CheckpointManager`` leave
  the bytes a clean run leaves.
* The supervised run rolled back by the port's plans.
* The site registry: the port's ``KNOWN_SITES`` equals the reference's, and
  every literal site of ``src/repro_torch`` is registered there and every
  registered site used (the reference's repolint rules (a) and (b), which
  read only the reference's registry).
"""
import ast
import dataclasses
import os
import warnings
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import repolint
from repro.testing import faults as jf
from repro_torch import io as tio
from repro_torch.io import (
    CheckpointManager,
    load_latest_valid,
    save_binary,
    verify_snapshot,
)
from repro_torch.io.async_writer import AsyncWriter, WriteJobError
from repro_torch.io.dcsr_binary import ShardWriteError, load_binary
from repro_torch.io.durability import fsync_override, write_bytes_verified
from repro_torch.snn import RasterMonitor, Session, SimConfig, balanced_ei, to_dcsr
from repro_torch.testing import (
    CHAOS_PLANS,
    Fault,
    FaultPlan,
    InjectedCrash,
    InjectedIOError,
    chaos_plan,
    fault_plans as tf,
    file_crc,
    no_faults,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
CPU = dict(device="cpu")


def small_net(k=2, seed=0):
    return to_dcsr(balanced_ei(n=80, seed=seed), k=k, uniform=True)


@pytest.fixture(autouse=True)
def _no_fsync():
    with fsync_override(False):
        yield


# -- harness parity with the reference ----------------------------------------

PUBLIC = ("Fault", "FaultPlan", "InjectedCrash", "InjectedIOError", "KNOWN_SITES",
          "STATE_KINDS", "KINDS", "CHAOS_PLANS", "active_plans", "fault_point",
          "apply_state_faults", "chaos_plan", "no_faults", "file_crc")


def test_every_public_name_has_a_counterpart():
    for name in PUBLIC:
        assert hasattr(jf, name) and hasattr(tf, name), name
    for name in ("KNOWN_SITES", "STATE_KINDS", "KINDS", "CHAOS_PLANS"):
        assert getattr(tf, name) == getattr(jf, name), name
    assert [(f.name, f.default) for f in dataclasses.fields(tf.Fault)] == \
        [(f.name, f.default) for f in dataclasses.fields(jf.Fault)]


def _both(faults, seed):
    """The same faults as a reference plan and as a port plan."""
    return (jf.FaultPlan([jf.Fault(**f) for f in faults], seed=seed),
            tf.FaultPlan([tf.Fault(**f) for f in faults], seed=seed))


def _outcome(fn, *args):
    try:
        fn(*args)
    except (InjectedCrash, jf.InjectedCrash, OSError) as e:
        return type(e).__name__, str(e)
    return None


HIT_PLANS = {
    "window": [dict(site="unit:a", kind="io_error", after=1, count=2)],
    "per_path_and_match": [dict(site="unit:a", kind="io_error", per_path=True),
                           dict(site="unit:b", kind="crash", match="part1", count=-1)],
    "stall_then_error": [dict(site="unit:a", kind="stall", delay_s=1e-4, count=-1),
                         dict(site="unit:a", kind="io_error", after=2, per_path=True)],
    **{name: [dict(site=f.site, kind=f.kind, per_path=f.per_path, count=f.count,
                   delay_s=f.delay_s) for f in jf.chaos_plan(name).faults]
       for name in jf.CHAOS_PLANS},
}
HITS = [(site, path) for _ in range(3)
        for site in ("unit:a", "unit:b", "shard_write", "shard_write:post",
                     "manifest_write", "manifest_write:post")
        for path in ("/x/part0.npz", "/x/part1.npz", None)]


@pytest.mark.parametrize("case", sorted(HIT_PLANS))
def test_fired_log_matches_the_reference(case):
    """One hit sequence through both harnesses: the same outcome at every
    hit (the exception's type and text) and the same ``fired`` log."""
    jp, tp = _both(HIT_PLANS[case], seed=3)
    with jf.no_faults(), no_faults(), jp, tp:
        for site, path in HITS:
            assert _outcome(tf.fault_point, site, path) == \
                _outcome(jf.fault_point, site, path), (site, path)
    assert tp.fired == jp.fired and tp.fired


DAMAGE = {
    "torn": dict(kind="torn"),
    "torn_frac_0.9": dict(kind="torn", frac=0.9),
    "torn_frac_none": dict(kind="torn", frac=None),
    "bit_flip": dict(kind="bit_flip"),
}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("case", sorted(DAMAGE))
def test_file_damage_is_byte_identical_to_the_reference(tmp_path, case, seed):
    """Torn and bit-flipped files, hit three times each under one plan,
    are byte-identical between the two harnesses."""
    rng = np.random.default_rng(seed)
    blobs = [rng.integers(0, 256, size, dtype=np.uint8).tobytes()
             for size in (2, 100, 4097, 65536)]
    out = {}
    for pkg, mod in (("ref", jf), ("port", tf)):
        d = tmp_path / pkg
        d.mkdir()
        paths = []
        for i, b in enumerate(blobs):
            (d / f"part{i}.npz").write_bytes(b)
            paths.append(str(d / f"part{i}.npz"))
        plan = mod.FaultPlan([mod.Fault("unit:damage", count=-1, **DAMAGE[case])], seed=seed)
        with jf.no_faults(), no_faults(), plan:
            for _ in range(3):
                for p in paths:
                    mod.fault_point("unit:damage", p)
        out[pkg] = [open(p, "rb").read() for p in paths]
        assert [k for _, _, k in plan.fired] == [DAMAGE[case]["kind"]] * 12
    assert out["port"] == out["ref"]
    assert out["port"] != blobs


@pytest.mark.parametrize("call", [
    lambda m: m.Fault("unit:site", "no-such-kind"),
    lambda m: m.Fault("unit:site", "stall"),
    lambda m: m.chaos_plan("no-such-plan"),
], ids=["unknown_kind", "stall_without_delay", "unknown_chaos_plan"])
def test_error_texts_match_the_reference(call):
    with pytest.raises(ValueError) as want:
        call(jf)
    with pytest.raises(ValueError) as got:
        call(tf)
    assert str(got.value) == str(want.value)


def _carries(v, k):
    carries = [{"vtx_state": torch.from_numpy(v[p].copy())} for p in range(k)]
    return carries, (carries if k > 1 else carries[0])


@pytest.mark.parametrize("kind", ["nan", "storm"])
@pytest.mark.parametrize("k", [1, 3])
def test_state_faults_hit_the_same_neuron_as_the_reference(k, kind):
    """``apply_state_faults`` on the port's carry (a dict at k = 1, the
    list of uniform ``(n_p, S)`` carries on spmd) against the reference's
    on its layout (``(n, S)``, the stacked ``(k, n_p, S)``): the same
    neuron and value at every firing hit (enough hits to reach every row,
    the partitions' first and last among them), written into the port's
    own tensors in place."""
    n_p, S, hits = 5, 3, 60
    v = np.random.default_rng(k).normal(-60.0, 5.0, (k, n_p, S)).astype(np.float32)
    jstate = {"vtx_state": jnp.asarray(v[0] if k == 1 else v)}
    carries, state = _carries(v, k)
    tensors = [c["vtx_state"] for c in carries]
    jp, tp = _both([dict(site="supervisor:state", kind=kind, after=1, count=-1)], seed=11)
    with jf.no_faults(), no_faults(), jp, tp:
        for _ in range(hits):
            jstate = jf.apply_state_faults("supervisor:state", jstate)
            assert tio.apply_state_faults("supervisor:state", state) is state
            want = np.asarray(jstate["vtx_state"]).reshape(k, n_p, S)
            got = np.stack([c["vtx_state"].numpy() for c in carries])
            np.testing.assert_array_equal(got, want)
    assert tp.fired == jp.fired and len(tp.fired) == hits - 1
    assert all(c["vtx_state"] is t for c, t in zip(carries, tensors))
    got = np.stack([t.numpy() for t in tensors])
    np.testing.assert_array_equal(got[..., 1:], v[..., 1:])
    if kind == "nan":
        assert np.isnan(got[..., 0]).all()
    else:
        assert (got[..., 0] == np.float32(1e4)).all()


@pytest.mark.parametrize("kind", ["crash", "io_error", "stall"])
def test_non_state_kinds_at_the_state_site(kind):
    """A crash, IO error or stall at ``supervisor:state`` runs as at a file
    site, in both packages, and leaves the state alone."""
    carries, state = _carries(np.zeros((2, 4, 3), np.float32), 2)
    jp, tp = _both([dict(site="supervisor:state", kind=kind, delay_s=1e-4)], seed=0)
    jstate = {"vtx_state": jnp.zeros((2, 4, 3), jnp.float32)}
    with jf.no_faults(), no_faults(), jp, tp:
        want = _outcome(jf.apply_state_faults, "supervisor:state", jstate)
        assert _outcome(tf.apply_state_faults, "supervisor:state", state) == want
    assert tp.fired == jp.fired == [("supervisor:state", None, kind)]
    assert not any(c["vtx_state"].any() for c in carries)


# -- the reference's scenarios on the port's io stack ---------------------------

def test_fault_hit_window_after_count():
    with no_faults(), FaultPlan(
        [Fault("unit:site", "io_error", after=1, count=2)], seed=0
    ) as plan:
        tio.fault_point("unit:site", "/a")            # hit 0: skipped (after=1)
        with pytest.raises(InjectedIOError):
            tio.fault_point("unit:site", "/a")        # hit 1: fires
        with pytest.raises(InjectedIOError):
            tio.fault_point("unit:site", "/a")        # hit 2: fires
        tio.fault_point("unit:site", "/a")            # hit 3: window exhausted
    assert [k for _, _, k in plan.fired] == ["io_error", "io_error"]


def test_fault_per_path_counts_independently():
    with no_faults(), FaultPlan(
        [Fault("unit:site", "io_error", per_path=True)], seed=0
    ):
        for p in ("/a", "/b"):
            with pytest.raises(InjectedIOError):
                tio.fault_point("unit:site", p)       # first hit of each path
            tio.fault_point("unit:site", p)           # second hit: healed


def test_fault_match_filters_by_path_substring():
    with no_faults(), FaultPlan(
        [Fault("unit:site", "io_error", match="part1", count=-1)], seed=0
    ):
        tio.fault_point("unit:site", "/x/part0.npz")
        with pytest.raises(InjectedIOError):
            tio.fault_point("unit:site", "/x/part1.npz")


def test_seeded_damage_is_deterministic(tmp_path):
    """Same plan seed -> byte-identical torn-write damage, independent of
    the path the fault happens to hit."""
    sizes = []
    for rep in range(2):
        fn = str(tmp_path / f"blob{rep}.bin")
        with open(fn, "wb") as f:
            f.write(bytes(range(256)) * 40)
        with no_faults(), FaultPlan([Fault("unit:site", "torn")], seed=42):
            tio.fault_point("unit:site", fn)
        sizes.append(os.path.getsize(fn))
    assert sizes[0] == sizes[1] < 256 * 40


WRITE_CASES = {
    "heals_transient_io": (Fault("shard_write", "io_error", count=2), 0, 2),
    "heals_torn_write": (Fault("shard_write:post", "torn", count=1), 3, 1),
    "raises_after_retries_exhausted": (Fault("shard_write", "io_error", count=-1), 0, None),
}


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_write_bytes_verified_under_faults(tmp_path, case):
    """Two transient failures, then the third attempt lands; a torn write
    caught by the read-back CRC and rewritten; a persistent failure raised
    after the last attempt."""
    fault, seed, fired = WRITE_CASES[case]
    fn = str(tmp_path / "x.bin")
    data = bytes(range(256)) * 16
    with no_faults(), FaultPlan([fault], seed=seed) as plan:
        if fired is None:
            with pytest.raises(OSError):
                write_bytes_verified(fn, data, "shard_write")
            return
        crc = write_bytes_verified(fn, data, "shard_write")
    assert len(plan.fired) == fired
    assert open(fn, "rb").read() == data
    assert crc == zlib.crc32(data)


def test_snapshot_write_heals_transient_shard_errors(tmp_path):
    """A full dCSR snapshot under per-path first-write failures comes out
    valid: the write layer retries, the manifest CRCs match the disk."""
    net = small_net()
    d = str(tmp_path / "snap")
    with no_faults(), FaultPlan(
        [Fault("shard_write", "io_error", per_path=True)], seed=1
    ) as plan:
        save_binary(net, d, t_now=7, atomic=True)
    assert plan.fired
    man, bad = verify_snapshot(d)
    assert bad == [] and man["t_now"] == 7
    net2, _, t = load_binary(d)
    assert t == 7
    np.testing.assert_array_equal(net2.parts[0].col_idx, net.parts[0].col_idx)


def test_bit_flip_on_read_is_detected(tmp_path):
    net = small_net()
    d = str(tmp_path / "snap")
    save_binary(net, d, t_now=0, atomic=True)
    with no_faults(), FaultPlan([Fault("shard_read", "bit_flip", count=1)], seed=5):
        with pytest.raises(IOError, match="corrupt"):
            load_binary(d, verify=True)
    # the flip hit the disk: a plain re-read still sees it
    with pytest.raises(IOError, match="corrupt"):
        load_binary(d, verify=True)


# (site, manifest.json left in the final dir, the step load_latest_valid finds)
CRASH_WINDOWS = {
    "atomic_dir:pre_swap": (True, 0),
    "atomic_dir:between_renames": (False, 0),
    "atomic_dir:after_swap": (True, 10),
}


@pytest.mark.parametrize("site", sorted(CRASH_WINDOWS))
def test_crash_windows_of_the_atomic_swap(tmp_path, site):
    """A crash before the swap keeps the previous snapshot; between the
    renames only ``.old`` holds a complete one and the restore falls back
    to it; after the swap, before the directory fsync, the new one is
    already the restore target.  The next write finishes any interrupted
    swap, clears ``.old`` and lands."""
    final_has_manifest, t_after = CRASH_WINDOWS[site]
    d = str(tmp_path / "snap")
    net = small_net()
    save_binary(net, d, t_now=0, atomic=True)
    with no_faults(), FaultPlan([Fault(site, "crash")], seed=0):
        with pytest.raises(InjectedCrash):
            save_binary(net, d, t_now=10, atomic=True)
    assert os.path.exists(os.path.join(d, "manifest.json")) == final_has_manifest
    if site != "atomic_dir:pre_swap":
        assert os.path.exists(os.path.join(d + ".old", "manifest.json"))
    _, _, t = load_latest_valid(d)
    assert t == t_after
    save_binary(net, d, t_now=20, atomic=True)
    assert not os.path.exists(d + ".old")
    _, _, t = load_latest_valid(d)
    assert t == 20


def _sweep_offsets(rng, size, k=4):
    """Seeded offsets + the section boundaries (header / tail)."""
    offs = {1, size // 2, max(size - 1, 1), max(size - 8, 1)}
    offs |= {int(o) for o in rng.integers(1, size, k)}
    return sorted(o for o in offs if 0 < o < size)


def test_truncation_sweep_dcsr_snapshots(tmp_path):
    """Truncating the manifest or any shard of the newest step at any
    offset: the walker restores the older valid step, never garbage."""
    root = str(tmp_path / "steps")
    net = small_net()
    save_binary(net, os.path.join(root, "step_00000000"), t_now=0, atomic=True)
    save_binary(net, os.path.join(root, "step_00000010"), t_now=10, atomic=True)
    newest = os.path.join(root, "step_00000010")
    rng = np.random.default_rng(2024)
    files = sorted(os.listdir(newest))
    assert set(files) == {"manifest.json", "part0.npz", "part1.npz"}
    for fn in files:
        full = os.path.join(newest, fn)
        pristine = open(full, "rb").read()
        for off in _sweep_offsets(rng, len(pristine)):
            with open(full, "wb") as f:
                f.write(pristine[:off])
            try:
                _, _, t = load_latest_valid(root)
            except (FileNotFoundError, OSError, ValueError):
                pass                     # clean failure is acceptable
            else:
                assert t == 0, f"truncated {fn}@{off} restored t={t}"
            with open(full, "wb") as f:
                f.write(pristine)
    _, _, t = load_latest_valid(root)
    assert t == 10


def test_truncation_sweep_tensor_checkpoints(tmp_path):
    root = str(tmp_path / "ckpt")
    tree = {"w": np.arange(600, dtype=np.float32).reshape(30, 20),
            "b": np.ones(20, np.float32)}
    mgr = CheckpointManager(root, async_write=False)
    mgr.save(0, tree)
    mgr.save(10, tree)
    newest = mgr.step_dir(10)
    rng = np.random.default_rng(7)
    for fn in sorted(os.listdir(newest)):
        full = os.path.join(newest, fn)
        pristine = open(full, "rb").read()
        for off in _sweep_offsets(rng, len(pristine), k=3):
            with open(full, "wb") as f:
                f.write(pristine[:off])
            try:
                restored, step = mgr.restore_latest_valid(like=tree)
            except FileNotFoundError:
                pass
            else:
                assert step == 0
                np.testing.assert_array_equal(restored["w"], tree["w"])
            with open(full, "wb") as f:
                f.write(pristine)
    _, step = mgr.restore_latest_valid(like=tree)
    assert step == 10


def test_async_writer_retries_transient_oserror():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("flaky disk")

    w = AsyncWriter(retries=2, retry_backoff_s=0.001)
    w.submit(flaky)
    w.wait()                             # healed on the third attempt
    assert len(calls) == 3
    w.close()


def test_async_writer_error_context_and_chain(tmp_path):
    orig = ShardWriteError(3, str(tmp_path / "part3.npz"), OSError("dead sector"))

    def boom():
        raise orig

    w = AsyncWriter(retries=0)
    w.submit(boom, context=dict(step=1200, path=str(tmp_path / "snap")))
    with pytest.raises(WriteJobError) as ei:
        w.wait()
    err = ei.value
    assert isinstance(err, OSError)
    assert err.step == 1200
    assert err.part_id == 3              # from the exception, not the ctx
    assert err.path == str(tmp_path / "part3.npz")
    assert err.__cause__ is orig
    msg = str(err)
    assert "step 1200" in msg and "partition 3" in msg and "part3" in msg
    w.close()


def test_async_writer_gives_up_after_retries():
    calls = []

    def always_fails():
        calls.append(1)
        raise OSError("still broken")

    w = AsyncWriter(retries=1, retry_backoff_s=0.001)
    w.submit(always_fails, context=dict(step=5))
    with pytest.raises(WriteJobError, match="step 5"):
        w.wait()
    assert len(calls) == 2               # original + one retry
    w.close()


def test_async_writer_does_not_retry_an_injected_crash():
    calls = []

    def crashes():
        calls.append(1)
        raise InjectedCrash("hard stop")

    w = AsyncWriter(retries=3, retry_backoff_s=0.001)
    w.submit(crashes)
    with pytest.raises(WriteJobError):
        w.wait()
    assert len(calls) == 1               # crashes are not transient
    w.close()


def test_no_faults_masks_active_plans(tmp_path):
    fn = str(tmp_path / "x.bin")
    with FaultPlan([Fault("shard_write", "io_error", count=-1)], seed=0):
        with no_faults():
            write_bytes_verified(fn, b"ok", "shard_write")
        with pytest.raises(OSError):
            write_bytes_verified(str(tmp_path / "y.bin"), b"no", "shard_write")
    assert open(fn, "rb").read() == b"ok"


def test_run_checkpoint_failure_names_last_good_step(tmp_path):
    """When the writer's retries exhaust, the error from
    ``Session.run(checkpoint_every=...)`` names the last successful step."""
    root = str(tmp_path / "ck")
    ses = Session(small_net(k=1), SimConfig(align_k=8), **CPU)
    with no_faults(), FaultPlan(
        [Fault("manifest_write", "io_error", match="step_00000060", count=-1)], seed=0
    ):
        with pytest.raises(OSError, match=r"last successful checkpoint: step 30") as ei:
            ses.run(90, checkpoint_every=30, checkpoint_dir=root, checkpoint_sync=True)
    assert "step 60" in str(ei.value)
    assert isinstance(ei.value.__cause__, WriteJobError)
    assert ei.value.__cause__.step == 60
    ses.close()


# -- chaos: every plan survived, the bytes a clean run leaves --------------------

def _tree_crcs(root):
    """``{relative path: file_crc}`` of every file under ``root``."""
    out = {}
    for dirpath, _dirs, names in os.walk(root):
        for n in names:
            full = os.path.join(dirpath, n)
            out[os.path.relpath(full, root)] = file_crc(full)
    return out


_TREE = {"w": np.arange(600, dtype=np.float32).reshape(30, 20),
         "b": [np.ones(20, np.float32), torch.arange(7)]}


def _chaos_workload(root):
    """``save_binary`` of a small net, ``Session.save``, a checkpointed run
    with retention and a ``CheckpointManager``, all under ``root``; the
    session's end carry."""
    net = small_net(seed=2)
    save_binary(net, os.path.join(root, "snap"), t_now=4, atomic=True)
    cfg = SimConfig(align_k=8)
    ses = Session(small_net(k=2, seed=2), cfg, engine="spmd", devices=["cpu"] * 2)
    ses.run(20, checkpoint_every=10, checkpoint_dir=os.path.join(root, "run"), max_to_keep=2)
    ses.save(os.path.join(root, "save"))
    end = [{k: v.clone() for k, v in c.items() if torch.is_tensor(v)} for c in ses.state]
    ses.close()
    mgr = CheckpointManager(os.path.join(root, "mgr"), max_to_keep=2)
    for step in (0, 5, 10):
        mgr.save(step, _TREE)
    mgr.wait()
    mgr.close()
    return end


@pytest.mark.parametrize("name", CHAOS_PLANS)
def test_chaos_plans_are_survivable(tmp_path, name):
    """Each named chaos plan is healed by the port's own retry and verify
    layers: every file a snapshot, a saved session, a checkpointed run and
    a tensor checkpoint leave on disk equals a clean run's byte for byte,
    and each restores (the run and the save to the same carry)."""
    with no_faults():
        clean = _chaos_workload(str(tmp_path / "clean"))
    with no_faults(), chaos_plan(name, seed=9) as plan:
        chaos = _chaos_workload(str(tmp_path / "chaos"))
    assert plan.fired and {k for _, _, k in plan.fired} == {f.kind for f in plan.faults}
    for a, b in zip(chaos, clean):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    want = _tree_crcs(str(tmp_path / "clean"))
    assert _tree_crcs(str(tmp_path / "chaos")) == want
    assert sorted(p.split(os.sep)[1] for p in want if p.startswith("run")) == \
        ["step_00000010"] * 3 + ["step_00000020"] * 3
    man, bad = verify_snapshot(str(tmp_path / "chaos" / "snap"))
    assert bad == [] and man["t_now"] == 4
    for sub in ("run", "save"):
        back = Session.restore(str(tmp_path / "chaos" / sub), engine="spmd",
                               devices=["cpu"] * 2)
        assert back.t == 20
        back.run(10)
        back.close()
    mgr = CheckpointManager(str(tmp_path / "chaos" / "mgr"), async_write=False)
    restored, step = mgr.restore_latest_valid(like=_TREE)
    assert step == 10 and np.array_equal(restored["w"], np.arange(600.0).reshape(30, 20))


# -- the supervised run under the port's plans ----------------------------------

def k1_net(seed=3):
    return to_dcsr(balanced_ei(n=120, seed=seed), k=1)


@pytest.fixture(scope="module")
def undisturbed():
    ses = Session(k1_net(), SimConfig(align_k=8), **CPU)
    ras = RasterMonitor()
    res = ses.run(120, monitors=[ras], chunk_size=30)
    return res, ras, ses.state["vtx_state"].clone()


@pytest.mark.parametrize("kind,detail", [
    ("nan", "non-finite membrane state (1 values)"),
    ("storm", "membrane runaway"),
])
def test_supervised_rollback_under_the_port_plan(tmp_path, undisturbed, kind, detail):
    """A ``nan`` or ``storm`` from the port's plan after the second chunk:
    the health gate catches it on that chunk, one rollback of 30 steps in
    place, and the raster, spike counts and membranes equal the undisturbed
    run's; no checkpoint on disk holds the poisoned state."""
    res_ref, ras_ref, v_ref = undisturbed
    ses = Session(k1_net(), SimConfig(align_k=8), **CPU)
    sim = ses.simulator
    ras = RasterMonitor()
    root = str(tmp_path / "ck")
    with no_faults(), FaultPlan([Fault("supervisor:state", kind, after=1, count=1)],
                                seed=5) as plan:
        with pytest.warns(UserWarning, match="rolled back"):
            res = ses.run_supervised(120, monitors=[ras], chunk_size=30,
                                     checkpoint_every=30, checkpoint_dir=root)
    assert plan.fired == [("supervisor:state", None, kind)]
    assert (res.rollbacks, res.steps_lost, res.t_final) == (1, 30, 120)
    assert res.events[0].kind == "health" and detail in res.events[0].detail
    np.testing.assert_array_equal(res.spike_count, res_ref.spike_count)
    np.testing.assert_array_equal(ras.raster, ras_ref.raster)
    assert torch.equal(ses.state["vtx_state"], v_ref)
    assert ses.simulator is sim and ses.last_rollbacks[0]["in_place"]
    ses.close()
    for step in tio.snapshot_steps(root):
        net_s, _, _ = load_binary(os.path.join(root, f"step_{step:08d}"))
        v = net_s.parts[0].vtx_state[:, 0]
        assert np.all(np.isfinite(v)) and np.all(np.abs(v) <= 1e3)


def test_supervised_k2_chaos_under_the_port_plan(tmp_path):
    """The reference's acceptance run on the port's spmd engine with the
    port's plan alone: a transient error on each shard's first write, a
    NaN after the second chunk, and the newest step's ``part0.npz``
    bit-flipped at its first read.  One rollback through the quarantine to
    t = 0, and the whole carry equal to an undisturbed run's."""
    spec = dict(engine="spmd", devices=["cpu"] * 2)
    cfg = SimConfig(align_k=8, exchange="dense")
    net = small_net(k=2, seed=4)
    ref = Session(net, cfg, **spec)
    res_ref = ref.run(90, chunk_size=30)
    ses = Session(small_net(k=2, seed=4), cfg, **spec)
    with no_faults(), FaultPlan([
        Fault("shard_write", "io_error", per_path=True),
        Fault("supervisor:state", "nan", after=1, count=1),
        Fault("shard_read", "bit_flip", match="step_00000030/part0", count=1),
    ], seed=11) as plan, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = ses.run_supervised(90, chunk_size=30, checkpoint_every=30,
                                 checkpoint_dir=str(tmp_path))
    kinds = [k for _, _, k in plan.fired]
    assert kinds.count("nan") == kinds.count("bit_flip") == 1 and "io_error" in kinds
    assert (res.rollbacks, res.steps_lost) == (1, 60)
    assert any(0 in ps for _, _, ps in res.restore_reports[0].quarantined)
    np.testing.assert_array_equal(res.spike_count, res_ref.spike_count)
    for a, b in zip(ses.state, ref.state):
        assert torch.equal(a["vtx_state"], b["vtx_state"])
    ses.close()
    ref.close()


# -- the site registry ------------------------------------------------------------

def _literal_sites(path):
    """``(line, site)`` of every literal site passed to ``fault_point``,
    ``apply_state_faults`` or ``write_bytes_verified`` in the file, read as
    the reference's repolint reads them."""
    f = repolint._load(path, ROOT)
    out = []
    for node in ast.walk(f.tree):
        if isinstance(node, ast.Call):
            name = repolint._callee_name(node.func)
            if name in repolint._SITE_FNS:
                pos, kw = repolint._SITE_FNS[name]
                site = repolint._str_arg(node, pos, kw=kw)
                if site is not None:
                    out.append((node.lineno, site))
    return out


def _unregistered_and_dead(files, known):
    used, bad = set(), []
    for path in files:
        for line, site in _literal_sites(path):
            base = site[:-5] if site.endswith(":post") else site
            used.add(base)
            if base not in known:
                bad.append(f"{os.path.relpath(path, ROOT)}:{line}: {site!r}")
    return bad, [s for s in known if s not in used]


def _port_py_files():
    return sorted(os.path.join(d, n) for d, _, names in os.walk(PORT)
                  for n in names if n.endswith(".py")
                  and not os.path.join(d, n).endswith(os.path.join("testing", "fault_plans.py")))


def test_port_sites_are_registered_and_alive():
    """Repolint's fault-hook rules (a) and (b) against the port's registry:
    every literal site of ``src/repro_torch`` (``:post`` folded) is in
    ``KNOWN_SITES``, every registered site has a call, and the registry is
    the reference's."""
    assert tf.KNOWN_SITES == jf.KNOWN_SITES
    bad, dead = _unregistered_and_dead(_port_py_files(), tf.KNOWN_SITES)
    assert bad == [] and dead == []


def test_registry_check_catches_a_planted_site(tmp_path):
    """The check above is live: an unregistered site and a dead one show."""
    planted = tmp_path / "planted.py"
    planted.write_text("def f(p):\n    fault_point('shard_wirte', p)\n"
                       "    write_bytes_verified(p, b'', site='shard_write:post')\n")
    bad, dead = _unregistered_and_dead([str(planted)], tf.KNOWN_SITES)
    assert len(bad) == 1 and "shard_wirte" in bad[0]
    assert "shard_write" not in dead and "supervisor:state" in dead


@pytest.mark.parametrize("rel", ["testing/__init__.py", "testing/fault_plans.py"])
def test_fault_plan_modules_import_neither_jax_nor_the_reference(rel):
    path = os.path.join(PORT, rel)
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module]
    assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not path.endswith(os.path.join("testing", "faults.py"))
