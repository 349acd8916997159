"""The port's simulation CLI (``python -m repro_torch.launch.simulate``) on
the CPU: the counterpart of ``tests/test_launchers.py``'s snapshot and
resume case, and the supervised run with a rollback."""
import math

from repro_torch.io import state_fault_hook
from repro_torch.launch.simulate import main as simulate_main


def test_simulate_cli_snapshot_resume(tmp_path, capsys):
    snap = str(tmp_path / "snap")
    simulate_main([
        "--device", "cpu", "--scale", "0.005", "--k", "2", "--steps", "60",
        "--snapshot-dir", snap, "--snapshot-every", "30",
    ])
    out = capsys.readouterr().out
    assert "snapshot @ t=60" in out
    # resume continues from t=60
    simulate_main([
        "--device", "cpu", "--scale", "0.005", "--k", "2", "--steps", "30",
        "--snapshot-dir", snap,
    ])
    out2 = capsys.readouterr().out
    assert "resumed at t=60" in out2
    assert "t=90" in out2


def test_simulate_cli_supervised_rolls_back(tmp_path, capsys):
    """``--supervised --distributed`` on two CPU partitions: a NaN put into
    one membrane after the second chunk rolls the run back to the t=20
    checkpoint; the run ends at t=60 and prints its rollback summary."""
    calls = []

    def poison(site, state):
        calls.append(site)
        if len(calls) == 2:
            state[1]["vtx_state"][3, 0] = math.nan
        return state

    with state_fault_hook(poison):
        simulate_main([
            "--device", "cpu", "--distributed", "--scale", "0.005", "--k", "2",
            "--steps", "60", "--snapshot-dir", str(tmp_path / "ck"),
            "--snapshot-every", "20", "--supervised", "--max-rollbacks", "2",
        ])
    out = capsys.readouterr().out
    assert "'engine': 'spmd'" in out
    assert "[simulate] t=60" in out
    assert "supervised: rollbacks=1 steps_lost=20 events=2" in out
    assert "health@t=40: non-finite membrane state (1 values)" in out
    assert "rollback@t=40: to step 20" in out
    assert set(calls) == {"supervisor:state"} and len(calls) == 4
