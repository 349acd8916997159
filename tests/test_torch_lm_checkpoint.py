"""The port's tensor ``CheckpointManager`` and its train launcher against the
reference's, on the CPU.

The same tree of numpy arrays saved by both packages' managers gives two
directories equal byte for byte (manifest and every shard).  The
reference's own manager tests (``tests/test_checkpoint.py``) run against
the port's manager, with the reference's ``FaultPlan`` driving the port's
fault sites through ``repro_torch.io.fault_hook``.  A checkpoint of either
package's train launcher resumes in the other, and the launcher's data
sharding follows a ``torch.distributed`` process group.
"""
import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.io import CheckpointManager as JCheckpointManager
from repro.launch.train import main as jtrain_main
from repro.testing.faults import Fault, FaultPlan
from repro.testing.faults import fault_point as j_fault_point
from repro_torch import convert
from repro_torch import io as tio
from repro_torch.configs import get_config
from repro_torch.io import CheckpointManager
from repro_torch.launch.train import main as train_main
from repro_torch.models import build_model, lm_param_leaves
from repro_torch.train import AdamW
from repro_torch.train.optimizer import flat_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU ops on one thread (tiny shapes; see
    ``tests/test_torch_lm_train.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree():
    return {
        "w": np.arange(24.0, dtype=np.float32).reshape(4, 6),
        "emb": {"table": np.ones((8, 4), np.float32) * 3},
        "step": np.asarray(7, np.int32),
    }


def _equal_trees(a, b):
    la, lb = tio.checkpoint.tree_flatten_with_path(a), tio.checkpoint.tree_flatten_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (_, x), (_, y) in zip(la, lb):
        x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
        y = y.numpy() if torch.is_tensor(y) else np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


# -- the same bytes as the reference -------------------------------------------------

def test_both_managers_write_the_same_bytes(tmp_path):
    """A tree with nested dicts, a tuple and a list, fp32, int8 and a 0-d
    int32, saved by both managers: the same files, byte for byte; each
    manager restores the other's directory."""
    rng = np.random.default_rng(0)
    t = dict(
        params=dict(b=rng.normal(size=(3, 5)).astype(np.float32),
                    a=(dict(z=np.ones(4, np.float32)), dict(z=np.zeros(4, np.float32))),
                    rest=[rng.normal(size=(2, 2, 2)).astype(np.float32)]),
        opt_state=dict(count=np.asarray(3, np.int32),
                       m=dict(q=rng.integers(-127, 128, (2, 3, 128)).astype(np.int8),
                              scale=rng.random((2, 3, 1)).astype(np.float32))),
    )
    jcm = JCheckpointManager(str(tmp_path / "ref"), async_write=False)
    tcm = CheckpointManager(str(tmp_path / "port"), async_write=False)
    jcm.save(12, t)
    tcm.save(12, {k: v for k, v in t.items()})
    want, got = _files(jcm.step_dir(12)), _files(tcm.step_dir(12))
    assert list(want) == list(got) and len(want) == 8
    for name in want:
        assert got[name] == want[name], name
    man = json.loads(got["manifest.json"])
    assert [e["name"] for e in man["leaves"]][:2] == ["['opt_state']['count']",
                                                      "['opt_state']['m']['q']"]
    out, step = tcm.restore(like=t)
    assert step == 12
    _equal_trees(out, t)
    out, _ = CheckpointManager(str(tmp_path / "ref")).restore(12, like=t)
    _equal_trees(out, t)
    jout, _ = jcm.restore(like=jax.tree.map(jnp.asarray, t))
    _equal_trees(jax.tree.map(np.asarray, jout), t)
    # torch tensors are saved as their arrays, a bf16 one is refused (F13)
    t = tree()
    tcm.save(13, dict(w=torch.from_numpy(t["w"]), step=torch.from_numpy(t["step"]),
                      emb=dict(table=torch.from_numpy(t["emb"]["table"]))))
    assert _files(tcm.step_dir(13)) == _files(
        CheckpointManager(str(tmp_path / "np"), async_write=False).save(13, tree()))
    with pytest.raises(TypeError, match="F13"):
        tcm.save(14, {"w": torch.ones(2, dtype=torch.bfloat16)})


# -- the reference's manager tests, on the port --------------------------------------

def test_roundtrip_and_manifest(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=False)
    t = tree()
    cm.save(5, t, wait=True)
    out, step = cm.restore(like=t, device="cpu")
    assert step == 5
    _equal_trees(out, t)
    man = json.load(open(os.path.join(cm.step_dir(5), "manifest.json")))
    assert all("index" in s for e in man["leaves"] for s in e["shards"])
    flat, _ = cm.restore()
    assert len(flat) == 3 and flat[0].dtype == torch.float32


def test_async_retention_gc(tmp_path):
    cm = CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, tree())
    cm.wait()
    assert cm.all_steps() == [3, 4]
    cm.close()


def test_corruption_falls_back(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(1, tree(), wait=True)
    cm.save(2, tree(), wait=True)
    d = cm.step_dir(2)
    npy = [f for f in os.listdir(d) if f.endswith(".npy")][0]
    with open(os.path.join(d, npy), "r+b") as f:
        f.write(b"\x00" * 16)
    _, step = cm.restore_latest_valid(like=tree())
    assert step == 1


def test_restore_latest_valid_walks_past_truncated_step(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=False)
    for s in (1, 2, 3):
        cm.save(s, tree(), wait=True)
    for s in (2, 3):
        d = cm.step_dir(s)
        p = os.path.join(d, sorted(f for f in os.listdir(d) if f.endswith(".npy"))[0])
        with open(p, "r+b") as f:
            f.truncate(max(os.path.getsize(p) // 2, 1))
    out, step = cm.restore_latest_valid(like=tree())
    assert step == 1
    _equal_trees(out, tree())


def test_restore_latest_valid_all_corrupt_raises(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(1, tree(), wait=True)
    with open(os.path.join(cm.step_dir(1), "manifest.json"), "w") as f:
        f.write("{not json")
    with pytest.raises(FileNotFoundError):
        cm.restore_latest_valid(like=tree())


def test_node_failure_partial_write(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(1, tree(), wait=True)
    torn = os.path.join(str(tmp_path), "step_00000002")
    os.makedirs(torn)
    open(os.path.join(torn, "leaf0_s0.npy"), "wb").write(b"junk")
    assert cm.latest_step() == 1
    _, step = cm.restore_latest_valid(like=tree())
    assert step == 1


def test_manager_torn_swap_restores_from_old(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(1, tree(), wait=True)
    cm.save(2, tree(), wait=True)
    d = cm.step_dir(2)
    os.replace(d, d + ".old")  # the crash window between the two renames
    assert cm.all_steps() == [1, 2] and cm.latest_step() == 2
    out, step = cm.restore_latest_valid(like=tree())
    assert step == 2
    _equal_trees(out, tree())
    assert cm.restore(2, like=tree())[1] == 2


def test_manager_gc_removes_old_siblings(tmp_path):
    cm = CheckpointManager(str(tmp_path), max_to_keep=2, async_write=False)
    cm.save(1, tree(), wait=True)
    os.replace(cm.step_dir(1), cm.step_dir(1) + ".old")
    for s in (2, 3, 4):
        cm.save(s, tree(), wait=True)
    assert cm.all_steps() == [3, 4]
    assert not os.path.exists(cm.step_dir(1) + ".old")


def test_async_wait_save_drains_older_queued_steps(tmp_path):
    cm = CheckpointManager(str(tmp_path), max_to_keep=1)
    orig = cm._write

    def slow_write(job):
        time.sleep(0.05)
        orig(job)

    cm._write = slow_write
    cm.save(1, tree())
    cm.save(2, tree(), wait=True)
    assert cm.all_steps() == [2]
    cm.close()


def test_manager_background_error_surfaces_on_wait(tmp_path):
    cm = CheckpointManager(str(tmp_path))

    def boom(job):
        raise IOError("disk on fire")

    cm._write = boom
    cm.save(1, tree())
    with pytest.raises(IOError, match="disk on fire"):
        cm.wait()
    cm.close()


def _changing_tree(case):
    """``(make, change)``: ``make()`` gives a tree of CPU tensors (or the
    launcher's tree of a reduced smollm and its AdamW state) and
    ``change()`` changes their values in place, as an optimizer step
    does."""
    if case == "tensors":
        t = {"a": torch.arange(6.0), "b": [torch.ones(2, 3), torch.zeros((), dtype=torch.int32)]}

        def change():
            t["a"].add_(100.0)
            t["b"][0].mul_(-1.0)
            t["b"][1].add_(5)

        return (lambda: t), change
    cfg = get_config("smollm-135m").reduced()
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    opt = AdamW(lr=1e-2)
    state = opt.init(lm_param_leaves(cfg, model))
    gen = torch.Generator().manual_seed(5)

    def change():
        opt.update([torch.randn(p.shape, generator=gen) for p in flat_params(state)], state)

    change()
    return (lambda: convert.lm_train_tree(cfg, model, state)), change


@pytest.mark.parametrize("case", ["tensors", "train_tree"])
def test_an_async_save_keeps_the_values_at_the_save(tmp_path, case):
    """An async save holds the tree's values at the time of the save: the
    tree changes in place while its write waits in the queue, and the
    restore gives the saved values, not the later ones."""
    make, change = _changing_tree(case)

    def host(x):
        return x.detach().numpy().copy() if torch.is_tensor(x) else np.array(x, copy=True)

    want = [host(x) for _, x in tio.checkpoint.tree_flatten_with_path(make())]
    cm = CheckpointManager(str(tmp_path))
    go = threading.Event()
    orig = cm._write

    def held_write(job):
        assert go.wait(60)
        orig(job)

    cm._write = held_write
    cm.save(1, make())
    change()
    go.set()
    cm.wait()
    got, _ = cm.restore(1)
    cm.close()
    now = [host(x) for _, x in tio.checkpoint.tree_flatten_with_path(make())]
    assert any(not np.array_equal(a, b) for a, b in zip(want, now))  # the change took
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=f"leaf {i}")


def test_a_mismatched_structure_walks_back(tmp_path):
    """A step whose leaves do not fill ``like`` (another optimizer's
    state) is skipped by the restore walker, as the reference's unflatten
    error is."""
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(1, tree())
    cm.save(2, dict(w=np.ones(3, np.float32)))
    _, step = cm.restore_latest_valid(like=tree())
    assert step == 1
    with pytest.raises(ValueError):
        cm.restore(2, like=tree())


@pytest.mark.parametrize("fault,step,want", [
    (Fault("shard_write", "io_error"), 2, (2, 8)),  # healed by the write's retry
    (Fault("shard_write:post", "torn"), 2, (2, 8)),  # caught by the read-back CRC, rewritten
    (Fault("manifest_write", "io_error", count=-1), 2, (1, 7)),  # every attempt fails
    (Fault("atomic_dir:between_renames", "crash"), 1, (1, 7)),  # a torn swap of step 1
])
def test_write_faults_from_the_reference_plan(tmp_path, fault, step, want):
    """The reference's ``FaultPlan`` at the port's sites: a transient
    error or a torn shard is healed inside the write; a write that keeps
    failing, or a crash between the swap's renames (step 1 written again),
    leaves the previous state restorable (from ``step_1.old`` in the
    torn swap)."""
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(1, tree())
    with tio.fault_hook(j_fault_point), FaultPlan([fault]) as plan:
        try:
            cm.save(step, dict(tree(), step=np.asarray(8, np.int32)))
        except Exception:
            assert want[1] == 7
    assert plan.fired, "the fault never fired"
    out, got = cm.restore_latest_valid(like=tree())
    assert (got, int(out["step"])) == want


def test_bit_rot_on_read_walks_back(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(1, tree())
    cm.save(2, tree())
    with tio.fault_hook(j_fault_point), FaultPlan(
            [Fault("shard_read", "bit_flip", match="step_00000002")]):
        _, step = cm.restore_latest_valid(like=tree())
    assert step == 1


# -- the train launcher -------------------------------------------------------------------

LAUNCH = ["--arch", "smollm-135m", "--reduced", "--seq", "32", "--global-batch", "4"]


def _leaves(root, step):
    cm = CheckpointManager(root)
    flat, _ = cm.restore(step)
    man = json.load(open(os.path.join(cm.step_dir(step), "manifest.json")))
    return {e["name"]: t for e, t in zip(man["leaves"], flat)}


def _resume_in(src, dst, step):
    os.makedirs(dst)
    shutil.copytree(os.path.join(src, f"step_{step:08d}"), os.path.join(dst, f"step_{step:08d}"))


def _close_runs(a, b, base):
    """Two runs' step-6 checkpoints from the same step 3 (``base``): the
    same leaves; each parameter's change since step 3 within 1e-2 of its
    leaf's largest change, each moment within 1e-3 of its leaf's largest
    (the packages' fp32 forwards and backwards round apart, and three Adam
    steps on logits of this size carry that into the run), the count 6."""
    assert list(a) == list(b)
    for name in a:
        x, y = a[name].double(), b[name].double()
        assert x.shape == y.shape and a[name].dtype == b[name].dtype, name
        if x.dim() == 0:
            assert float(x) == float(y) == 6, name
            continue
        if name.startswith("['params']"):
            x, y, tol = x - base[name].double(), y - base[name].double(), 1e-2
        else:
            tol = 1e-3
        r = float((x - y).abs().max()) / max(float(y.abs().max()), 1e-12)
        assert r <= tol, (name, r)


@pytest.mark.parametrize("first", ["reference", "port"])
def test_a_launcher_checkpoint_resumes_in_the_other_package(tmp_path, capsys, first):
    """One package's launcher runs 6 steps with checkpoints at 3 and 6; the
    other resumes its step 3 (alone in a new directory, so the schedule and
    the data are the same run's) to step 6, which matches the straight
    run's step 6."""
    a, b = str(tmp_path / "straight"), str(tmp_path / "resumed")
    mains = dict(reference=lambda argv: jtrain_main(argv),
                 port=lambda argv: train_main(argv + ["--device", "cpu"]))
    second = "port" if first == "reference" else "reference"
    mains[first](LAUNCH + ["--steps", "6", "--ckpt", a, "--ckpt-every", "3"])
    _resume_in(a, b, 3)
    mains[second](LAUNCH + ["--steps", "6", "--ckpt", b, "--ckpt-every", "3"])
    assert "resumed from step 3" in capsys.readouterr().out
    _close_runs(_leaves(a, 6), _leaves(b, 6), _leaves(a, 3))


def test_train_cli_fresh_and_resume(tmp_path, capsys):
    """``tests/test_launchers.py``'s train cases on the port's launcher."""
    ck = str(tmp_path / "ck")
    train_main(LAUNCH + ["--steps", "6", "--ckpt", ck, "--ckpt-every", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "fresh start" in out and "done" in out
    assert os.path.exists(os.path.join(ck, "step_00000006"))
    train_main(LAUNCH + ["--steps", "8", "--ckpt", ck, "--ckpt-every", "4", "--device", "cpu"])
    assert "resumed from step 6" in capsys.readouterr().out
    train_main(["--arch", "xlstm-350m", "--reduced", "--steps", "3", "--seq", "16",
                "--global-batch", "2", "--opt8bit", "--device", "cpu"])
    assert "done" in capsys.readouterr().out
    if not torch.cuda.is_available():  # the card unless told otherwise: never the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_main(LAUNCH + ["--steps", "1"])


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), REPRO_FSYNC="0")


def test_sigterm_saves_and_exits(tmp_path):
    """SIGTERM mid-run: the step in flight finishes, the launcher saves the
    state it reached under the next step and exits 0; a relaunch resumes
    there."""
    ck = str(tmp_path / "ck")
    code = textwrap.dedent(f"""
        import os, signal, sys, torch
        torch.set_num_threads(1)
        from repro_torch.launch import train
        argv = {LAUNCH!r} + ["--steps", "1000", "--ckpt", {ck!r}, "--ckpt-every", "1000",
                             "--device", "cpu"]
        orig = train.fit
        def fit(*a, **kw):
            log = kw["log_fn"]
            def log_fn(msg):
                log(msg)
                if "step     0" in msg:
                    os.kill(os.getpid(), signal.SIGTERM)
            kw["log_fn"], kw["log_every"] = log_fn, 1
            return orig(*a, **kw)
        train.fit = fit
        train.main(argv)
    """)
    out = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "SIGTERM: checkpointing at step 1 and exiting" in out.stdout
    cm = CheckpointManager(ck)
    assert cm.all_steps() == [1]
    leaves = _leaves(ck, 1)
    assert int(leaves["['opt_state']['count']"]) == 1


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_each_read_their_shard(tmp_path):
    """Two processes in a gloo group run the launcher for 2 steps: each
    reads ``host_batch(n_hosts=2, host_id=rank)`` (the counterpart of
    ``jax.process_count()`` / ``process_index()``) and no gradient is
    exchanged (F12), so their parameters part."""
    port = _free_port()
    code = textwrap.dedent("""
        import sys, torch, torch.distributed as dist
        torch.set_num_threads(1)
        rank, port, ck = int(sys.argv[1]), sys.argv[2], sys.argv[3]
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                                rank=rank)
        from repro_torch.launch import train
        seen = []
        orig = train.batch_iterator
        def spy(dc, start_step=0):
            for step, batch in orig(dc, start_step):
                seen.append((dc.n_hosts, dc.host_id, step, int(batch["tokens"].long().sum())))
                yield step, batch
        train.batch_iterator = spy
        train.main(%r + ["--steps", "2", "--ckpt", ck, "--ckpt-every", "2", "--device", "cpu"])
        print("SEEN", seen, flush=True)
        dist.barrier()
        dist.destroy_process_group()
    """ % LAUNCH)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port),
                               str(tmp_path / f"ck{r}")], env=_env(), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-2000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    from repro_torch.train import DataConfig, host_batch

    cfg = get_config("smollm-135m").reduced()
    for rank, out in enumerate(outs):
        seen = eval(out.split("SEEN", 1)[1].strip().splitlines()[0])
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, n_hosts=2,
                        host_id=rank)
        assert seen[:2] == [(2, rank, s, int(host_batch(dc, s)["tokens"].long().sum()))
                            for s in range(2)]
    a, b = _leaves(str(tmp_path / "ck0"), 2), _leaves(str(tmp_path / "ck1"), 2)
    key = "['params']['emb']['embed']"
    assert a[key].shape == (cfg.vocab_size, cfg.d_model) and not torch.equal(a[key], b[key])


def test_train_tree_round_trips_an_8bit_state(tmp_path):
    """``convert.lm_train_tree`` -> the manager -> ``lm_params_from_arrays``
    and ``lm_opt_state_from_arrays`` gives back the model's parameters and
    the 8-bit state exactly (recurrentgemma reduced at 8 layers: groups and
    rest)."""
    import dataclasses

    cfg = dataclasses.replace(get_config("recurrentgemma-2b").reduced(), n_layers=8)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    opt = AdamW(quantize_moments=True)
    state = opt.init(lm_param_leaves(cfg, model))
    from repro_torch.train.optimizer import flat_params

    state, _ = opt.update([torch.randn(p.shape) for p in flat_params(state)], state)
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(1, convert.lm_train_tree(cfg, model, state))
    twin = build_model(cfg, device="cpu")
    like = convert.lm_train_tree(cfg, twin, opt.init(lm_param_leaves(cfg, twin)), like=True)
    tree, _ = cm.restore(1, like=like)
    twin.load_state_dict(convert.lm_params_from_arrays(cfg, tree["params"]))
    for (k, a), (_, b) in zip(model.state_dict().items(), twin.state_dict().items()):
        assert torch.equal(a, b), k
    back = convert.lm_opt_state_from_arrays(cfg, twin, tree["opt_state"])
    assert int(back["count"]) == 1
    for key in ("m", "v"):
        for x, y in zip(state[key], back[key]):
            assert torch.equal(x["q"], y["q"]) and torch.equal(x["scale"], y["scale"])
    names = [leaf.name for leaf in back["leaves"]]
    assert names[0] == "['emb']['embed']" and "['rest'][1]['mlp']['w_out']['w']" in names
