"""The port's snapshots (``repro_torch.io`` and ``Session.save`` /
``restore`` / ``Session(path)`` / ``run(checkpoint_every=...)``) on the CPU.

* The io layer behaves as the reference's (``tests/test_serialization.py``,
  ``tests/test_format_version.py``): CRC checks, atomic writes, the
  newest-valid walk with its ``.old`` fallbacks, the thread-pool writer,
  host copies and the ``format_version`` contract.
* Files cross packages: a snapshot written by ``repro.io`` loads in
  ``repro_torch.io`` with equal arrays and manifest (minus ``crc``, since
  ``np.savez`` stamps the time into every zip entry), and the other way
  round; ``docs/FORMAT.md``'s NumPy-only example reads a port snapshot.
* Sessions cross packages: a JAX ``Session`` saved mid-run continues in the
  port and the other way round, with identical rasters and the state
  within 1e-4 (f32 gather sums in another order).  The noise is the
  reference's, through the ``_noise_fn`` seam.
* Within the port every continuation is bit-identical: save at k=4,
  restore at k=1, 2 and 4 (plastic weights and traces through disk),
  checkpointed runs with retention and a corrupt newest step, sync and
  async writes, and write faults from the reference's ``FaultPlan``
  driven through the port's hook.
"""
import json
import os
import re
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import io as jio
from repro.builder import balanced_ei_rules as j_balanced_ei_rules
from repro.builder import build_network as j_build_network
from repro.snn import Session as JSession
from repro.snn import SimConfig as JSimConfig
from repro.snn import monitors as jmon
from repro.snn import network as jnet
from repro.testing.faults import Fault, FaultPlan, InjectedCrash
from repro.testing.faults import fault_point as j_fault_point
from repro_torch import io as tio
from repro_torch.builder import balanced_ei_rules, build_network
from repro_torch.core import hash_partition, rcb_partition, repartition
from repro_torch.io.dcsr_binary import FORMAT_VERSION, check_format_version
from repro_torch.snn import RasterMonitor, Session, SimConfig
from repro_torch.snn import network as tnet
from repro_torch.snn.reshard import concat_runtime, reshard_sim_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOC = os.path.join(ROOT, "docs", "FORMAT.md")
CPU4 = dict(engine="spmd", devices=["cpu"] * 4)
PARTS = ("row_ptr", "col_idx", "vtx_model", "vtx_state", "edge_model", "edge_state",
         "coords", "global_ids")


@pytest.fixture(autouse=True)
def _no_fsync():
    # throwaway state: the crash-window guarantees under test do not
    # depend on fsync, only power-loss durability does
    with tio.fsync_override(False), jio.fsync_override(False):
        yield


# -- nets ----------------------------------------------------------------------

def _net(mod, kind, k=1, uniform=False):
    """``mc``: microcircuit(0.01); ``ei``: balanced_ei(200, stdp=True) with
    a bias that drives it (plastic weights and traces change)."""
    if kind == "mc":
        net = mod.microcircuit(scale=0.01, seed=0)
    else:
        net = mod.balanced_ei(200, stdp=True, seed=3)
        net.vtx_state[:, 2] += 6.0
    return mod.to_dcsr(net, k=k, uniform=uniform)


def _spatial(mod, n=90, k=3, seed=6, stdp=True):
    net = mod.spatial_random(n, avg_degree=6, seed=seed, stdp=stdp)
    return mod.to_dcsr(net, assignment=rcb_partition(net.coords, k))


def _reference_noise(net):
    """The reference's noise draw at ``SimConfig().seed``, for the seam."""
    sigma, n = float(net.meta["noise_sigma"]), net.n
    key = jax.random.PRNGKey(SimConfig().seed)
    draw = jax.jit(
        lambda t: sigma * jax.random.normal(jax.random.fold_in(key, t), (n,), jnp.float32)
    )
    return lambda t: np.asarray(draw(t))


# -- comparisons ---------------------------------------------------------------

def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _assert_same_files(a, b):
    """Two snapshot dirs hold equal arrays in every shard and equal
    manifests but for the CRCs."""
    ma, mb = _manifest(a), _manifest(b)
    assert set(ma["crc"]) == set(mb["crc"])
    ma.pop("crc")
    mb.pop("crc")
    assert ma == mb
    for fn in sorted(_manifest(a)["crc"]):
        with np.load(os.path.join(a, fn)) as za, np.load(os.path.join(b, fn)) as zb:
            assert za.files == zb.files, fn
            for key in za.files:
                assert za[key].dtype == zb[key].dtype, (fn, key)
                np.testing.assert_array_equal(za[key], zb[key], err_msg=f"{fn} {key}")


def _by_permanent_id(net, sim_state):
    """A snapshot's content in the permanent labelling, whatever its k and
    assignment: vertex state, runtime arrays, and the edge list
    ``(dst, src, model, state...)`` sorted."""
    gids = np.concatenate([p.global_ids for p in net.parts])
    order = np.argsort(gids)
    vtx = np.concatenate([p.vtx_state for p in net.parts])[order]
    runtime = {key: arr[..., order] for key, arr in concat_runtime(sim_state).items()}
    edges = np.concatenate([
        np.column_stack([np.repeat(p.global_ids, np.diff(p.row_ptr)), gids[p.col_idx],
                         p.edge_model, p.edge_state])
        for p in net.parts
    ])
    return vtx, runtime, edges[np.lexsort(edges.T[::-1])]


def _assert_same_content(a, b, tol=0.0):
    (va, ra, ea), (vb, rb, eb) = a, b
    close = dict(rtol=tol, atol=tol)
    np.testing.assert_allclose(va, vb, **close)
    assert set(ra) == set(rb)
    for key in ra:
        if key == "hist":
            np.testing.assert_array_equal(ra[key], rb[key])
        else:
            np.testing.assert_allclose(ra[key], rb[key], err_msg=key, **close)
    np.testing.assert_array_equal(ea[:, :3], eb[:, :3])
    np.testing.assert_allclose(ea[:, 3:], eb[:, 3:], **close)


def _saved(ses, path):
    ses.save(path)
    net, sim_state, t = tio.load_binary(path)
    return t, _by_permanent_id(net, sim_state)


def _corrupt(fn, mode):
    if mode == "flip":
        raw = bytearray(open(fn, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(fn, "wb").write(bytes(raw))
    else:
        with open(fn, "r+b") as f:
            f.truncate(os.path.getsize(fn) // 2)


# -- the io layer, against the reference's behaviour ----------------------------

@pytest.mark.parametrize("mode", ["flip", "trunc"])
def test_crc_detects_a_flipped_byte_and_a_truncated_shard(tmp_path, mode):
    d = tnet.to_dcsr(tnet.spatial_random(60, avg_degree=5, seed=1), k=2)
    tio.save_binary(d, str(tmp_path))
    _corrupt(os.path.join(tmp_path, "part1.npz"), mode)
    with pytest.raises(IOError, match="corrupt"):
        tio.load_binary(str(tmp_path))
    man, bad = tio.verify_snapshot(str(tmp_path))
    assert bad == [1] and int(man["k"]) == 2
    tio.quarantine_shards(str(tmp_path), bad)
    assert os.path.exists(os.path.join(tmp_path, "part1.npz.quarantine"))


def test_atomic_save_never_leaves_a_partial_dir(tmp_path):
    d = tnet.to_dcsr(tnet.spatial_random(50, avg_degree=5, seed=2), k=1)
    dst = str(tmp_path / "snap")
    tio.save_binary(d, dst, t_now=3, atomic=True)
    assert not os.path.exists(dst + ".tmp")
    assert tio.load_binary(dst)[2] == 3
    tio.save_binary(d, dst, t_now=9, atomic=True)
    assert tio.load_binary(dst)[2] == 9
    assert not os.path.exists(dst + ".old")
    assert tio.load_latest_valid(dst)[2] == 9


def test_load_latest_valid_walks_step_dirs(tmp_path):
    d = tnet.to_dcsr(tnet.spatial_random(50, avg_degree=5, seed=2), k=1)
    for step in (10, 20, 30):
        tio.save_binary(d, str(tmp_path / f"step_{step:08d}"), t_now=step)
    _corrupt(str(tmp_path / "step_00000030" / "part0.npz"), "flip")
    _corrupt(str(tmp_path / "step_00000020" / "part0.npz"), "trunc")
    assert tio.load_latest_valid(str(tmp_path))[2] == 10
    with pytest.raises(FileNotFoundError):
        tio.load_latest_valid(str(tmp_path / "missing"))


def test_load_latest_valid_torn_swap_old_fallbacks(tmp_path):
    """Only ``.old`` survives a crash between atomic_dir's renames: found
    in the single-dir form and in a step root (preferred over older steps,
    and walked past when it is corrupt too); a corrupt final with an
    intact ``.old`` sibling falls back to it."""
    d = tnet.to_dcsr(tnet.spatial_random(50, avg_degree=5, seed=2), k=1)
    dst = str(tmp_path / "snap")
    tio.save_binary(d, dst, t_now=4, atomic=True)
    os.replace(dst, dst + ".old")
    assert tio.load_latest_valid(dst)[2] == 4

    root = tmp_path / "root"
    for step in (10, 20, 30):
        tio.save_binary(d, str(root / f"step_{step:08d}"), t_now=step)
    newest = str(root / "step_00000030")
    os.replace(newest, newest + ".old")
    assert tio.snapshot_steps(str(root)) == [10, 20, 30]
    assert tio.load_latest_valid(str(root))[2] == 30
    _corrupt(os.path.join(newest + ".old", "part0.npz"), "trunc")
    assert tio.load_latest_valid(str(root))[2] == 20

    final = str(tmp_path / "final")
    tio.save_binary(d, final + ".old", t_now=4)
    tio.save_binary(d, final, t_now=9)
    _corrupt(os.path.join(final, "part0.npz"), "trunc")
    assert tio.load_latest_valid(final)[2] == 4


def test_thread_pool_write_equals_save_binary(tmp_path):
    d = _spatial(tnet)
    rng = np.random.default_rng(1)
    sim_state = {p.part_id: dict(ring=rng.random((4, p.n)).astype(np.float32),
                                 tr_plus=rng.random(p.n).astype(np.float32))
                 for p in d.parts}
    a, b = str(tmp_path / "sync"), str(tmp_path / "pool")
    tio.save_binary(d, a, sim_state=sim_state, t_now=7, atomic=True)
    tio.write_snapshot(tio.snapshot_network(d, sim_state, t_now=7), b, atomic=True,
                       max_workers=3)
    _assert_same_files(a, b)


def test_snapshot_copies_survive_mutation(tmp_path):
    d = tnet.to_dcsr(tnet.spatial_random(40, avg_degree=5, seed=3), k=1)
    ring = np.ones((3, d.n), np.float32)
    want_vtx, want_edge = d.parts[0].vtx_state.copy(), d.parts[0].edge_state.copy()
    snap = tio.snapshot_network(d, {0: dict(ring=ring)}, t_now=2)
    d.parts[0].vtx_state[:] += 123.0
    d.parts[0].edge_state[:, 0] = -1.0
    ring[:] = 0.0
    tio.write_snapshot(snap, str(tmp_path / "snap"))
    n2, s2, _ = tio.load_binary(str(tmp_path / "snap"))
    np.testing.assert_array_equal(n2.parts[0].vtx_state, want_vtx)
    np.testing.assert_array_equal(n2.parts[0].edge_state, want_edge)
    np.testing.assert_array_equal(s2[0]["ring"], np.ones((3, d.n), np.float32))


def _rewrite_version(path, version):
    man = _manifest(path)
    if version is None:
        man.pop("format_version", None)
    else:
        man["format_version"] = version
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(man, f)


@pytest.mark.parametrize("case", ["roundtrip", "future_minor", "future_major",
                                  "unparseable", "missing"])
def test_format_version_cases(tmp_path, case):
    """The five cases of ``tests/test_format_version.py`` on the port's
    reader."""
    d = _spatial(tnet, seed=11, stdp=False)
    path = str(tmp_path / "snap")
    tio.save_binary(d, path, t_now=5)
    current = f"{FORMAT_VERSION[0]}.{FORMAT_VERSION[1]}"
    assert FORMAT_VERSION == jio.dcsr_binary.FORMAT_VERSION
    if case == "roundtrip":
        assert _manifest(path)["format_version"] == current
        d2, _, t = tio.load_binary(path)
        assert t == 5 and (d2.n, d2.m) == (d.n, d.m)
    elif case == "future_minor":
        _rewrite_version(path, f"{FORMAT_VERSION[0]}.{FORMAT_VERSION[1] + 7}")
        with pytest.warns(UserWarning, match="newer minor revision"):
            assert tio.load_binary(path)[0].m == d.m
    elif case == "future_major":
        _rewrite_version(path, f"{FORMAT_VERSION[0] + 1}.0")
        with pytest.raises(ValueError, match="newer than this reader"):
            tio.load_binary(path)
    elif case == "unparseable":
        _rewrite_version(path, "banana")
        with pytest.raises(ValueError, match="unparseable format_version"):
            tio.load_binary(path)
    else:
        _rewrite_version(path, None)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert tio.load_binary(path)[0].m == d.m
        assert check_format_version({}) == FORMAT_VERSION
    if case in ("roundtrip", "missing"):  # the stamp survives a reshard
        r = repartition(tio.load_binary(path)[0], hash_partition(d.n, 2, seed=4))
        tio.save_binary(r, str(tmp_path / "resharded"))
        assert _manifest(str(tmp_path / "resharded"))["format_version"] == current


def test_lazy_partition_load_matches_the_reference(tmp_path):
    d = _spatial(tnet)
    tio.save_binary(d, str(tmp_path))
    tn, _, _ = tio.load_binary(str(tmp_path), parts=[1])
    jn, _, _ = jio.load_binary(str(tmp_path), parts=[1])
    assert tn.loaded_parts == jn.loaded_parts == frozenset({1})
    for pt, pj in zip(tn.parts, jn.parts):
        for key in PARTS:
            np.testing.assert_array_equal(getattr(pt, key), getattr(pj, key))


# -- files across packages -------------------------------------------------------

@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshot_files_cross_packages(tmp_path, writer):
    """The same net and runtime written by either package: equal arrays and
    manifests (but the CRCs), and each package loads the other's file with
    equal arrays."""
    jd, td = _spatial(jnet), _spatial(tnet)
    rng = np.random.default_rng(2)
    sim_state = {p.part_id: dict(ring=rng.random((5, p.n)).astype(np.float32),
                                 hist=(rng.random((5, p.n)) < 0.2).astype(np.uint8),
                                 tr_plus=rng.random(p.n).astype(np.float32),
                                 tr_minus=rng.random(p.n).astype(np.float32))
                 for p in td.parts}
    a, b = str(tmp_path / "jax"), str(tmp_path / "torch")
    jio.save_binary(jd, a, sim_state=sim_state, t_now=11, atomic=True)
    tio.save_binary(td, b, sim_state=sim_state, t_now=11, atomic=True)
    _assert_same_files(a, b)
    src = a if writer == "reference" else b
    reader = tio if writer == "reference" else jio
    got_net, got_state, t = reader.load_binary(src)
    want_net = jd if writer == "reference" else td
    assert t == 11 and got_net.k == want_net.k and got_net.meta == want_net.meta
    np.testing.assert_array_equal(got_net.dist, want_net.dist)
    assert got_net.registry.to_entries() == want_net.registry.to_entries()
    for pg, pw in zip(got_net.parts, want_net.parts):
        for key in PARTS:
            got, want = getattr(pg, key), getattr(pw, key)
            assert got.dtype == want.dtype, key
            np.testing.assert_array_equal(got, want, err_msg=key)
    for p in sim_state:
        for key in sim_state[p]:
            np.testing.assert_array_equal(got_state[p][key], sim_state[p][key])


def test_rule_spec_is_equal_in_both_manifests(tmp_path):
    jd = j_build_network(j_balanced_ei_rules(n=400, stdp=True, seed=5), k=2, uniform=True,
                         path="ref")
    td = build_network(balanced_ei_rules(n=400, stdp=True, seed=5), 2, uniform=True,
                       path="ref")
    assert td.rule_spec == jd.rule_spec
    a, b = str(tmp_path / "jax"), str(tmp_path / "torch")
    jio.save_binary(jd, a, t_now=0)
    tio.save_binary(td, b, t_now=0)
    assert _manifest(a)["rule_spec"] == _manifest(b)["rule_spec"] == json.loads(
        json.dumps(td.rule_spec))
    _assert_same_files(a, b)
    assert tio.load_binary(a)[0].rule_spec == jio.load_binary(b)[0].rule_spec


def test_format_doc_example_reads_a_port_snapshot(tmp_path):
    """``docs/FORMAT.md``'s NumPy-only script, extracted as
    ``tests/test_format_doc.py`` does, on a snapshot the port's Session
    wrote, with neither package on the path."""
    with open(DOC) as f:
        blocks = re.findall(r"```python\n(.*?)```", f.read(), flags=re.DOTALL)
    scripts = [b for b in blocks if "sys.argv[1]" in b]
    assert len(scripts) == 1 and "repro" not in scripts[0]
    td = tnet.to_dcsr(tnet.spatial_random(120, avg_degree=8, seed=3, stdp=True), k=3,
                      uniform=True)
    ses = Session(td, SimConfig(align_k=8), engine="spmd", devices=["cpu"] * 3)
    ses.run(12)
    snap = str(tmp_path / "snap")
    ses.save(snap)
    script = tmp_path / "read_shard.py"
    script.write_text(scripts[0])
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(script), snap], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "OK: partition 0 of 3" in out.stdout and "strongest from" in out.stdout


# -- sessions across packages -----------------------------------------------------

CONT = (40, 30)  # steps before the save, steps after the restore


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """Per net: the reference Session's uninterrupted run (raster and its
    snapshot at the end) and its snapshot at step CONT[0]."""
    out = {}
    for kind in ("mc", "ei"):
        root = tmp_path_factory.mktemp(f"ref_{kind}")
        with jio.fsync_override(False):
            jses = JSession(_net(jnet, kind), JSimConfig(align_k=32))
            ras = jmon.RasterMonitor()
            jses.run(CONT[0], monitors=[ras])
            jses.save(str(root / "mid"))
            jses.run(CONT[1], monitors=[ras])
            jses.save(str(root / "end"))
        out[kind] = dict(raster=ras.raster, mid=str(root / "mid"), end=str(root / "end"),
                         sigma=jses.net.meta["noise_sigma"])
    return out


def _end_content(path):
    net, sim_state, t = tio.load_binary(path)
    return t, _by_permanent_id(net, sim_state)


@pytest.mark.parametrize("kind", ["mc", "ei"])
def test_reference_snapshot_continues_in_the_port(reference_runs, tmp_path, kind):
    ref = reference_runs[kind]
    jd = _net(jnet, kind)
    ses = Session.restore(ref["mid"], cfg=SimConfig(align_k=32), device="cpu",
                          _noise_fn=_reference_noise(jd))
    assert ses.t == CONT[0] and ses.describe()["source_k"] == 1
    ras = RasterMonitor()
    ses.run(CONT[1], monitors=[ras])
    assert ref["raster"].sum() > 0
    np.testing.assert_array_equal(ras.raster, ref["raster"][CONT[0]:])
    t, got = _saved(ses, str(tmp_path / "end"))
    t_ref, want = _end_content(ref["end"])
    assert t == t_ref == sum(CONT)
    _assert_same_content(got, want, tol=1e-4)
    if kind == "ei":  # the weights learned in the port
        t_mid, mid = _end_content(ref["mid"])
        assert not np.array_equal(got[2][:, 3:], mid[2][:, 3:])


@pytest.mark.parametrize("kind", ["mc", "ei"])
def test_port_snapshot_continues_in_the_reference(reference_runs, tmp_path, kind):
    ref = reference_runs[kind]
    jd = _net(jnet, kind)
    ses = Session(_net(tnet, kind), SimConfig(align_k=32), device="cpu",
                  _noise_fn=_reference_noise(jd))
    ras = RasterMonitor()
    ses.run(CONT[0], monitors=[ras])
    np.testing.assert_array_equal(ras.raster, ref["raster"][:CONT[0]])
    mid = str(tmp_path / "mid")
    ses.save(mid)
    jses = JSession.restore(mid, cfg=JSimConfig(align_k=32))
    assert jses.t == CONT[0]
    jras = jmon.RasterMonitor()
    jses.run(CONT[1], monitors=[jras])
    np.testing.assert_array_equal(jras.raster, ref["raster"][CONT[0]:])
    end = str(tmp_path / "end")
    jses.save(end)
    _assert_same_content(_end_content(end)[1], _end_content(ref["end"])[1], tol=1e-4)


# -- within the port: bit-identical continuation ------------------------------------

@pytest.fixture(scope="module")
def k4_saved(tmp_path_factory):
    """Per net: a k=4 session on four CPU devices saved at step 40, then its
    own continuation (raster and snapshot at the end)."""
    out = {}
    for kind in ("mc", "ei"):
        root = tmp_path_factory.mktemp(f"k4_{kind}")
        with tio.fsync_override(False):
            ses = Session(_net(tnet, kind, k=4, uniform=True), SimConfig(align_k=8), **CPU4)
            ses.run(CONT[0])
            ses.save(str(root / "mid"))
            ras = RasterMonitor()
            ses.run(CONT[1], monitors=[ras])
            end = _saved(ses, str(root / "end"))
        out[kind] = dict(mid=str(root / "mid"), raster=ras.raster, end=end)
    return out


@pytest.mark.parametrize("kind", ["mc", "ei"])
@pytest.mark.parametrize("k", [4, 2, 1])
def test_k4_snapshot_continues_at_any_k(k4_saved, tmp_path, kind, k):
    ref = k4_saved[kind]
    place = CPU4 if k == 4 else dict(engine="spmd", devices=["cpu"] * 2) if k == 2 \
        else dict(device="cpu")
    ses = Session.restore(ref["mid"], k=k, cfg=SimConfig(align_k=8), **place)
    assert (ses.k, ses.t) == (k, CONT[0])
    assert set(ses.restore_seconds) == {"load", "reshard", "build"}
    ras = RasterMonitor()
    ses.run(CONT[1], monitors=[ras])
    assert ref["raster"].sum() > 0
    # block partitions of the merged labelling keep the rows in place
    np.testing.assert_array_equal(ras.raster, ref["raster"])
    t, got = _saved(ses, str(tmp_path / "end"))
    assert t == ref["end"][0]
    _assert_same_content(got, ref["end"][1])
    if kind == "ei":
        vtx, runtime, edges = got
        assert runtime["tr_plus"].any() and runtime["tr_minus"].any()
        mid = _by_permanent_id(*tio.load_binary(ref["mid"])[:2])
        assert not np.array_equal(edges[:, 3], mid[2][:, 3])


def test_restore_with_an_assignment_and_a_merged_session(k4_saved, tmp_path):
    """An explicit assignment reshards (the raster in the permanent
    labelling is the live run's); a k=4 snapshot on the single engine
    merges, keeps ``source_k`` and saves k=1."""
    ref = k4_saved["mc"]
    net = tio.load_binary(ref["mid"])[0]
    ses = Session.restore(ref["mid"], assignment=hash_partition(net.n, 3, seed=1),
                          cfg=SimConfig(align_k=8), device="cpu")
    assert (ses.k, ses.source_k, ses.engine_kind) == (1, 3, "single")
    ras = RasterMonitor()
    ses.run(CONT[1], monitors=[ras])
    perm = np.concatenate([p.global_ids for p in net.parts])
    np.testing.assert_array_equal(ras.raster[:, np.argsort(ses.permanent_ids)],
                                  ref["raster"][:, np.argsort(perm)])
    merged = Session(ref["mid"], SimConfig(align_k=8), device="cpu")
    assert (merged.k, merged.source_k, merged.t) == (1, 4, CONT[0])
    merged.run(CONT[1])
    t, got = _saved(merged, str(tmp_path / "merged"))
    assert int(_manifest(str(tmp_path / "merged"))["k"]) == 1
    _assert_same_content(got, ref["end"][1])


def test_reshard_sim_state_permutes_runtime_with_rows():
    d = _spatial(tnet, n=60, k=3)
    rng = np.random.default_rng(0)
    sim_state = {p.part_id: dict(ring=rng.random((3, p.n)).astype(np.float32))
                 for p in d.parts}
    before = _by_permanent_id(d, sim_state)
    new_net, new_state = reshard_sim_state(d, sim_state, hash_partition(d.n, 2, seed=3))
    assert new_net.k == 2
    _assert_same_content(_by_permanent_id(new_net, new_state), before)


@pytest.mark.parametrize("engine", ["single", "spmd"])
def test_checkpointed_run_gc_resume_and_corrupt_newest(tmp_path, engine):
    place = CPU4 if engine == "spmd" else dict(device="cpu")
    build = (lambda: _net(tnet, "ei", k=4, uniform=True)) if engine == "spmd" \
        else (lambda: _net(tnet, "ei"))
    cfg = SimConfig(align_k=8)
    root = str(tmp_path / "ck")
    whole = Session(build(), cfg, **place)
    want = RasterMonitor()
    whole.run(90, monitors=[want])
    with Session(build(), cfg, **place) as ses:
        ras = RasterMonitor()
        ses.run(60, monitors=[ras], chunk_size=25, checkpoint_every=20, checkpoint_dir=root,
                max_to_keep=2)
        assert ses.last_run_chunks == (20, 20, 20)
        assert len(ses.last_ckpt_stalls) == 3
    assert tio.snapshot_steps(root) == [40, 60]
    np.testing.assert_array_equal(ras.raster, want.raster[:60])
    resumed = Session(root, cfg, **place)
    assert resumed.t == 60 and resumed.restore_seconds["reshard"] == 0.0
    r = RasterMonitor()
    resumed.run(30, monitors=[r])
    np.testing.assert_array_equal(r.raster, want.raster[60:])
    for p in range(4 if engine == "spmd" else 1):
        _corrupt(os.path.join(root, "step_00000060", f"part{p}.npz"), "trunc")
    back = Session(root, cfg, **place)
    assert back.t == 40
    r = RasterMonitor()
    back.run(50, monitors=[r])
    np.testing.assert_array_equal(r.raster, want.raster[40:])


def test_sync_and_async_checkpoints_hold_equal_arrays(tmp_path):
    cfg = SimConfig(align_k=8)
    a_root, s_root = str(tmp_path / "async"), str(tmp_path / "sync")
    with Session(_net(tnet, "ei"), cfg, device="cpu") as sa:
        sa.run(40, chunk_size=10, checkpoint_every=20, checkpoint_dir=a_root)
    ss = Session(_net(tnet, "ei"), cfg, device="cpu")
    ss.run(40, chunk_size=10, checkpoint_every=20, checkpoint_dir=s_root, checkpoint_sync=True)
    assert tio.snapshot_steps(a_root) == tio.snapshot_steps(s_root) == [20, 40]
    for step in (20, 40):
        _assert_same_files(os.path.join(a_root, f"step_{step:08d}"),
                           os.path.join(s_root, f"step_{step:08d}"))


def test_async_save_is_a_copy_of_the_live_carry(tmp_path):
    """On the CPU the carry's arrays and the synced partitions are views of
    live tensors: a save held back by a slow disk (a reference ``stall``
    fault) while the session runs on still writes the state of its step."""
    cfg = SimConfig(align_k=8)
    ses = Session(_net(tnet, "ei"), cfg, device="cpu")
    ses.run(20)
    with tio.fault_hook(j_fault_point), FaultPlan(
            [Fault("shard_write", "stall", delay_s=0.5)]) as plan:
        ses.save(str(tmp_path / "late"), wait=False)
        ses.run(20)
        ses.wait()
    assert ("shard_write", str(tmp_path / "late.tmp" / "part0.npz"), "stall") in plan.fired
    ref = Session(_net(tnet, "ei"), cfg, device="cpu")
    ref.run(20)
    ref.save(str(tmp_path / "now"))
    _assert_same_files(str(tmp_path / "late"), str(tmp_path / "now"))


def test_write_faults_through_the_hook(tmp_path):
    """The reference's ``FaultPlan`` drives the port's write path: a
    transient ``io_error`` at ``shard_write`` is healed by the retries, a
    persistent one re-raises in ``wait()``, and a ``crash`` between
    ``atomic_dir``'s renames re-raises there too and leaves the previous
    snapshot as ``.old``, which restores."""
    cfg = SimConfig(align_k=8)
    ses = Session(_net(tnet, "ei"), cfg, device="cpu")
    ses.run(10)
    path = str(tmp_path / "snap")
    with tio.fault_hook(j_fault_point):
        with FaultPlan([Fault("shard_write", "io_error")]) as plan:
            ses.save(path)
        assert [f[2] for f in plan.fired] == ["io_error"]
        assert Session(path, cfg, device="cpu").t == 10

        ses.run(10)
        with FaultPlan([Fault("shard_write", "io_error", count=-1)]):
            ses.save(str(tmp_path / "never"), wait=False)
            with pytest.raises(tio.WriteJobError, match="step 20"):
                ses.wait()
        assert not os.path.exists(str(tmp_path / "never"))

        with FaultPlan([Fault("atomic_dir:between_renames", "crash")]):
            ses.save(path, wait=False)
            with pytest.raises(tio.WriteJobError) as err:
                ses.wait()
        assert isinstance(err.value.__cause__, InjectedCrash)
    assert not os.path.exists(path) and os.path.exists(path + ".old")
    back = Session(path, cfg, device="cpu")
    assert back.t == 10
    ses.save(path)  # the writer stays usable and finishes the torn swap
    assert Session(path, cfg, device="cpu").t == 20 and not os.path.exists(path + ".old")
    ses.close()


def test_background_error_raises_at_the_next_checkpoint(tmp_path):
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    ses = Session(_net(tnet, "mc"), SimConfig(align_k=8), device="cpu")
    ses.run(5)
    ses.save(str(blocker / "snap"), wait=False)
    ses._writer._q.join()
    with pytest.raises(OSError):
        ses.run(10, checkpoint_every=5, checkpoint_dir=str(tmp_path / "ck"))
    ses.save(str(tmp_path / "ok"))
    assert os.path.exists(str(tmp_path / "ok" / "manifest.json"))
    ses.close()


def test_nan_weight_snapshot_restores_on_row_dot(tmp_path):
    d = _net(tnet, "mc")
    cfg = SimConfig(align_k=8)
    clean = Session(d, cfg, device="cpu").describe()["reduce"]
    assert set(clean) == {"active"}
    part = d.parts[0]
    part.edge_state[0, 0] = np.nan
    ses = Session(d, cfg, device="cpu")
    nan_reduce = ses.describe()["reduce"]
    assert "row_dot" in nan_reduce
    ses.run(10)
    ses.save(str(tmp_path / "snap"))
    back = Session.restore(str(tmp_path / "snap"), cfg=cfg, device="cpu")
    assert back.describe()["reduce"] == nan_reduce
    a, b = RasterMonitor(), RasterMonitor()
    ses.run(10, monitors=[a])
    back.run(10, monitors=[b])
    np.testing.assert_array_equal(a.raster, b.raster)


def test_load_runtime_refuses_another_ring_depth():
    ses = Session(_net(tnet, "mc"), SimConfig(align_k=8), device="cpu")
    n, d = ses.n, ses.d_ring
    ses._pending_runtime = {0: dict(ring=np.zeros((d + 1, n), np.float32))}
    with pytest.raises(ValueError, match="ring"):
        ses.state
    st = ses.simulator.load_runtime(ses.simulator.init_state(7), {0: dict(
        hist=np.ones((d, n), np.uint8), tr_plus=np.ones(n, np.float64))})
    assert st["t"] == 7 and st["hist"].dtype == torch.uint8 and st["hist"].sum() == d * n
    assert st["tr_plus"].dtype == torch.float32
