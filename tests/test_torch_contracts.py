"""The port's engine-contract checker (``repro_torch.analysis.contracts``)
on the CPU, mirroring the reference's ``tests/test_analysis.py:57-201``:
each deliberately broken step must fail its contract with a message naming
what broke, and every row of the matrix must pass.

The brokenness is planted in real steps (the ops view sees what a step
does): ``ops.step_noise_add``, which every k = 1 engine without the step
front calls once a step, is wrapped so that each step also makes a float64
value, reads a value back to the host, or makes an int64 or an O(n^2)
vector; and a k = 2 engine's exchange is made to exchange twice.
"""
import subprocess
import sys

import pytest
import torch

from repro.kernels.dispatch import ENGINE_CONTRACTS as J_ENGINE_CONTRACTS
from repro_torch.analysis import contracts
from repro_torch.analysis.contracts import (
    CaseSpec, check_step_facts, contract_matrix, exchange_key, run_case, step_facts,
)
from repro_torch.kernels import dispatch, ops
from repro_torch.kernels.dispatch import ENGINE_CONTRACTS, STEP_ENGINES, EngineContract

STEPS = 3
K1_UNFUSED = CaseSpec("k1_unfused", 1, "unfused", "identity")
K2_DENSE = CaseSpec("k2_split_dense_off", 2, "fused_split", "dense")


def _facts(spec, steps=STEPS):
    sim, n_global, rows = contracts.build_sim(spec, "cpu")
    return step_facts(sim, steps), n_global, rows


def _verdict(spec, facts, n_global, rows, contract=None):
    contract = contract or ENGINE_CONTRACTS[spec.engine]
    return check_step_facts(facts, contract, spec.key, n_global=n_global, rows=rows)


def _planted(monkeypatch, extra):
    """Each step's ``ops.step_noise_add`` also runs ``extra(out)``."""
    own = ops.step_noise_add

    def step_noise_add(*args, **kwargs):
        out = own(*args, **kwargs)
        extra(out)
        return out

    monkeypatch.setattr(ops, "step_noise_add", step_noise_add)


# -- broken steps must fail -------------------------------------------------

def test_extra_exchange_fails_contract(monkeypatch):
    sim, n_global, rows = contracts.build_sim(K2_DENSE, "cpu")
    own = sim._exchange

    def exchange_twice(spikes, tr_plus):
        sim._gather(spikes)  # a second all_gather of the spikes
        return own(spikes, tr_plus)

    monkeypatch.setattr(sim, "_exchange", exchange_twice)
    facts = step_facts(sim, STEPS)
    assert facts.exchanges == 2 * STEPS
    problems = _verdict(K2_DENSE, facts, n_global, rows)
    assert any(f"{2 * STEPS} exchange(s) over {STEPS} steps" in p and "'fused_split'" in p
               for p in problems), problems
    # the conforming engine passes the same contract
    monkeypatch.undo()
    ok, n_global, rows = _facts(K2_DENSE)
    assert ok.exchanges == STEPS
    assert _verdict(K2_DENSE, ok, n_global, rows) == []


def test_undeclared_exchange_key_fails():
    facts, n_global, rows = _facts(K2_DENSE)
    toy = EngineContract("toy", {"dense": 1})
    problems = check_step_facts(facts, toy, exchange_key("index", True), n_global=n_global,
                                rows=rows)
    assert any("index+plastic" in p and "not a declared" in p for p in problems), problems


def test_float64_leak_fails_contract(monkeypatch):
    _planted(monkeypatch, lambda out: out.double() + 1.0)
    facts, n_global, rows = _facts(K1_UNFUSED)
    assert facts.wide_values, "expected a float64 value in the step"
    problems = _verdict(K1_UNFUSED, facts, n_global, rows)
    assert any("float64" in p and "8-byte" in p for p in problems), problems


def test_host_sync_in_a_step_fails(monkeypatch):
    _planted(monkeypatch, lambda out: out.sum().item())
    facts, n_global, rows = _facts(K1_UNFUSED)
    assert len(facts.host_syncs) == STEPS
    problems = _verdict(K1_UNFUSED, facts, n_global, rows)
    assert any("host sync" in p and "_local_scalar_dense" in p for p in problems), problems


def test_undeclared_int64_fails(monkeypatch):
    _planted(monkeypatch, lambda out: torch.arange(out.shape[0]))
    facts, n_global, rows = _facts(K1_UNFUSED)
    problems = _verdict(K1_UNFUSED, facts, n_global, rows)
    assert any("int64" in p and "simulator.py:make_core_step.<locals>.chain" in p
               for p in problems), problems


def test_undeclared_0d_int64_fails(monkeypatch):
    """A 0-d int64 (an int sum, an argmax) made in a step is no carry t."""
    _planted(monkeypatch, lambda out: (out > 0).sum().to(torch.int64))
    facts, n_global, rows = _facts(K1_UNFUSED)
    problems = _verdict(K1_UNFUSED, facts, n_global, rows)
    assert any("int64" in p and "simulator.py:make_core_step.<locals>.chain" in p
               for p in problems), problems


def test_extra_t_values_fail():
    """More 0-d int64 values at the carry's t places than one copy of t
    and one t + 1 a step per partition fail."""
    facts, n_global, rows = _facts(K2_DENSE)
    assert facts.partitions == 2 and facts.int64_values["t"] == 2 * (STEPS + 1)
    assert _verdict(K2_DENSE, facts, n_global, rows) == []
    facts.int64_values["t"] += 1
    problems = _verdict(K2_DENSE, facts, n_global, rows)
    assert any("carry's t places" in p for p in problems), problems


def test_no_card_and_no_device_raises(monkeypatch):
    """The checker runs on the card unless given ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        contracts.build_sim(K1_UNFUSED)


def test_quadratic_vector_fails(monkeypatch):
    _planted(monkeypatch, lambda out: torch.zeros(out.shape[0] ** 2))
    facts, n_global, rows = _facts(K1_UNFUSED)
    problems = _verdict(K1_UNFUSED, facts, n_global, rows)
    assert any("1-D f32 value of width" in p for p in problems), problems


def test_a_row_that_fails_to_run_is_a_breach(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("planted")

    monkeypatch.setattr(ops, "step_noise_add", broken)
    violations, results = contracts.run_matrix([K1_UNFUSED], device="cpu", verbose=False)
    assert violations and "planted" in violations[0][1]


# -- the clean codebase passes ----------------------------------------------

def test_contracts_match_the_reference():
    """One contract per engine, with the reference's exchange keys and
    counts, no host sync allowed anywhere."""
    assert set(ENGINE_CONTRACTS) == set(STEP_ENGINES) == set(J_ENGINE_CONTRACTS)
    for engine, c in ENGINE_CONTRACTS.items():
        assert c.exchanges_per_step == J_ENGINE_CONTRACTS[engine].collectives_per_step, engine
        assert c.host_syncs_per_step == 0
        assert set(c.int64_places) <= set(dispatch.INT64_PLACES)


def test_matrix_covers_every_engine():
    from repro.analysis.contracts import contract_matrix as j_contract_matrix

    specs = contract_matrix()
    assert {s.engine for s in specs} == set(STEP_ENGINES)
    mine = {(s.name, s.k, s.engine, s.key, s.gather, s.overlap) for s in specs if s.max_k is None}
    assert mine == {(s.name, s.k, s.engine, s.key, s.gather, s.overlap)
                    for s in j_contract_matrix()}
    assert {s.name for s in specs if s.max_k is not None} == {
        "k1_unfused_maxk", "k1_unfused_plastic_maxk"}


@pytest.mark.parametrize("spec", contract_matrix(), ids=lambda s: s.name)
def test_clean_row_passes(spec):
    res = run_case(spec, steps=STEPS, device="cpu")
    assert res.problems == [], res.problems
    assert res.engine == spec.engine
    want = ENGINE_CONTRACTS[spec.engine].exchanges_per_step[spec.key]
    assert res.facts.exchanges == want * STEPS and res.facts.ops > 0


def test_cli_exits_0():
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.contracts",
                          "--device", "cpu", "--steps", "2"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "OK: 25 configuration(s)" in out.stdout
    listed = subprocess.run([sys.executable, "-m", "repro_torch.analysis.contracts", "--list"],
                            capture_output=True, text=True, timeout=120)
    assert listed.returncode == 0 and "k1_unfused_plastic_maxk" in listed.stdout
