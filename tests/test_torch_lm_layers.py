"""The LM substrate's layers in the port against the reference's, on the CPU.

Each case makes its inputs with numpy from a seed, initializes the
reference's parameters (``repro.models``' ``*_init``), loads the same
arrays into the port's module (``convert.tree_state_dict``) and runs the
reference: its small ops (rope, the norms, sdpa, the MLPs) op by op, as
its own tests run them, and its attention, MoE and recurrent blocks under
``jax.jit``, as its ``greedy_generate`` runs them (a tenth of the time of
op by op on the CPU).  Everything is fp32; the port
and the reference agree within atol 1e-4 and rtol 1e-4 (their matmuls and
sums associate differently; the reference agrees with itself to 1.1e-5
across a cache and a cache-free forward, ROADMAP F10).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import layers as JL
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.models import xlstm as jxlstm
from repro_torch.configs import get_config as tget
from repro_torch.convert import tree_state_dict
from repro_torch.models import layers as TL
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trglru
from repro_torch.models import xlstm as txlstm

TOL = dict(rtol=1e-4, atol=1e-4)
GEN = torch.Generator().manual_seed(0)


def _cfgs(arch, **fields):
    """The reduced config of ``arch`` in both packages, with ``fields``."""
    return (dataclasses.replace(jget(arch).reduced(), **fields),
            dataclasses.replace(tget(arch).reduced(), **fields))


def _load(module, jparams):
    module.load_state_dict(tree_state_dict(jax.tree.map(np.asarray, jparams)))
    return module


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               **(tol or TOL))


def _x(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _jit(fn, *static):
    """The reference's ``fn (p, x, cfg, ...)`` under ``jax.jit``, ``cfg``
    and the keyword arguments ``static`` static."""
    return jax.jit(fn, static_argnums=(2,), static_argnames=static)


# -- rope and the norms -------------------------------------------------------

@pytest.mark.parametrize("pos_2d", [False, True])
def test_rope_is_the_half_split(rng, pos_2d):
    x = _x(rng, 2, 7, 4, 16)
    pos = rng.integers(0, 4096, (2, 7) if pos_2d else (7,)).astype(np.int32)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    _close(got, want)
    # the half split, not interleaved pairs: position 0 is the identity
    zero = TL.rope(torch.from_numpy(x), torch.zeros(7, dtype=torch.int32), 10000.0)
    assert torch.equal(zero, torch.from_numpy(x))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms(rng, kind):
    x = (3.0 + 2.0 * _x(rng, 2, 5, 64))
    p = JL.norm_init(kind, 64, jnp.float32)
    p = dict(p, scale=jnp.asarray(1.0 + _x(rng, 64)))
    if kind == "layernorm":
        p["nbias"] = jnp.asarray(_x(rng, 64))
    mod = _load(TL.Norm(kind, 64, torch.float32, "cpu"), p)
    _close(mod(torch.from_numpy(x)), JL.norm_apply(kind, p, jnp.asarray(x)), rtol=1e-5, atol=1e-5)


# -- attention -----------------------------------------------------------------

ATTN_CASES = [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, window=3),
    dict(causal=True, prefix_len=4),
    dict(causal=True, window=5, prefix_len=3),
]


@pytest.mark.parametrize("kw", ATTN_CASES, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
@pytest.mark.parametrize("H,KV", [(4, 2), (4, 1), (4, 4)])
def test_sdpa_gqa_and_masks(rng, kw, H, KV):
    q, k, v = _x(rng, 2, 9, H, 8), _x(rng, 2, 9, KV, 8), _x(rng, 2, 9, KV, 8)
    want = JL.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = TL.sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    _close(got, want)


@pytest.mark.parametrize("k_valid", [0, 1, 5, 9])
def test_sdpa_k_valid_and_a_fully_masked_row(rng, k_valid):
    """A decode query over ``k_valid`` cache slots; ``k_valid = 0`` masks the
    whole row, which stays finite (-1e30, not -inf) and uniform."""
    q, k, v = _x(rng, 2, 1, 4, 8), _x(rng, 2, 9, 2, 8), _x(rng, 2, 9, 2, 8)
    want = JL.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                   k_valid=jnp.asarray(k_valid))
    got = TL.sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=False,
                  k_valid=torch.tensor(k_valid))
    assert torch.isfinite(got).all()
    _close(got, want)


@pytest.mark.parametrize("kw", ATTN_CASES[:4], ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
@pytest.mark.parametrize("H,KV,bq,bk", [(4, 2, 4, 4), (4, 1, 5, 3), (1, 1, 4, 4), (1, 1, 5, 7)])
def test_chunked_attention_against_the_reference(rng, kw, H, KV, bq, bk):
    """Small blocks, padded edges.  Both packages agree; with one head both
    equal sdpa, with more the reference's final reshape mixes heads and
    positions (ROADMAP F11), and the port keeps it."""
    S = 13
    q, k, v = _x(rng, 2, S, H, 8), _x(rng, 2, S, KV, 8), _x(rng, 2, S, KV, 8)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    tq, tk, tv = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    want = jax.jit(JL.chunked_attention, static_argnames=(
        "causal", "window", "prefix_len", "block_q", "block_k"))(
        jq, jk, jv, block_q=bq, block_k=bk, **kw)
    got = TL.chunked_attention(tq, tk, tv, block_q=bq, block_k=bk, **kw)
    _close(got, want)
    full = TL.sdpa(tq, tk, tv, **kw)
    if H == 1:
        _close(got, JL.sdpa(jq, jk, jv, **kw))
        torch.testing.assert_close(got, full, rtol=1e-4, atol=1e-4)
    else:
        assert float((got - full).abs().max()) > 1e-2  # F11, in both packages
        assert float(np.abs(np.asarray(want) - full.numpy()).max()) > 1e-2


def test_long_prefill_takes_the_chunked_route(monkeypatch, rng):
    """More than 2048 tokens take chunked_attention, as in the reference."""
    jcfg, tcfg = _cfgs("smollm-135m")
    mod = TL.Attention(tcfg, torch.float32, "cpu", GEN)
    seen = []
    real = TL.chunked_attention
    monkeypatch.setattr(TL, "chunked_attention", lambda *a, **kw: seen.append(a[0].shape[1])
                        or real(*a, **kw))
    for S in (2048, 2049):
        x = torch.from_numpy(_x(rng, 1, S, tcfg.d_model))
        pos = torch.arange(S)[None]
        with torch.no_grad():
            mod(x, positions=pos)
    assert seen == [2049]


def _attn_pair(rng, arch="smollm-135m", **fields):
    jcfg, tcfg = _cfgs(arch, **fields)
    p = JL.attention_init(jax.random.PRNGKey(int(rng.integers(1 << 30))), jcfg, jnp.float32)
    return jcfg, tcfg, p, _load(TL.Attention(tcfg, torch.float32, "cpu", GEN), p)


@pytest.mark.parametrize("S,Sc", [(5, 8), (8, 8), (13, 8), (21, 8)])
def test_windowed_prefill_cache_write(rng, S, Sc):
    k = _x(rng, 2, S, 2, 16)
    cache = _x(rng, 2, Sc, 2, 16)
    want = JL._prefill_cache_write(jnp.asarray(k), jnp.asarray(cache), 8)
    got = TL.prefill_cache_write(torch.from_numpy(k), torch.from_numpy(cache.copy()), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("pos", [9, 14])
def test_attention_prefill_then_decode(rng, window, pos):
    """Prefill 9 tokens into a cache of 10 slots (a ring of 6 with a
    window), then one decode step at ``pos``: at 9 the last slot, past the
    end the write clamps to it, a ring writes at ``pos % 6``."""
    jcfg, tcfg, p, mod = _attn_pair(rng, window=window)
    Sc = min(window, 10) if window else 10
    x = _x(rng, 2, 9, jcfg.d_model)
    pos9 = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    apply = _jit(JL.attention_apply, "window")
    jc = dict(k=jnp.zeros((2, Sc, 2, 16)), v=jnp.zeros((2, Sc, 2, 16)))
    tc = dict(k=torch.zeros((2, Sc, 2, 16)), v=torch.zeros((2, Sc, 2, 16)))
    jy, jc = apply(p, jnp.asarray(x), jcfg, positions=jnp.asarray(pos9), window=window,
                   cache=jc)
    with torch.no_grad():
        ty, tc = mod(torch.from_numpy(x), positions=torch.from_numpy(pos9.copy()),
                     window=window, cache=tc)
    _close(ty, jy)
    for key in "kv":
        _close(tc[key], jc[key])
    x1 = _x(rng, 2, 1, jcfg.d_model)
    p1 = np.full((2, 1), pos, np.int32)
    jy, jc = apply(p, jnp.asarray(x1), jcfg, positions=jnp.asarray(p1), window=window,
                   cache=jc, cache_pos=jnp.asarray(pos))
    with torch.no_grad():
        ty, tc = mod(torch.from_numpy(x1), positions=torch.from_numpy(p1), window=window,
                     cache=tc, cache_pos=torch.tensor(pos))
    _close(ty, jy)
    for key in "kv":
        _close(tc[key], jc[key])
    slot = pos % Sc if window else min(pos, Sc - 1)
    assert float(tc["k"][:, slot].abs().sum()) > 0


# -- MLPs, MoE ------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_kinds(rng, kind):
    jcfg, tcfg = _cfgs("smollm-135m", mlp=kind)
    p = JL.mlp_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    mod = _load(TL.MLP(tcfg, torch.float32, "cpu", GEN), p)
    x = _x(rng, 2, 6, jcfg.d_model)
    with torch.no_grad():
        _close(mod(torch.from_numpy(x)), JL.mlp_apply(p, jnp.asarray(x), jcfg))


def test_positions_in_expert_are_the_stable_ranks(rng):
    e = rng.integers(0, 5, (3, 40)).astype(np.int32)
    want = np.stack([np.asarray(jmoe._positions_in_expert(jnp.asarray(r), 5)) for r in e])
    got = tmoe.positions_in_expert(torch.from_numpy(e).long(), 5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch,cf", [("granite-moe-3b-a800m", 0.3), ("granite-moe-3b-a800m", 1.25),
                                     ("kimi-k2-1t-a32b", 0.5)])
def test_moe_with_drops_and_its_aux(rng, arch, cf):
    """A small capacity factor forces drops; the output and the three aux
    values (load balance, z-loss, drop fraction) agree."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=cf)
    p = jmoe.moe_init(jax.random.PRNGKey(4), jcfg, jnp.float32)
    mod = _load(tmoe.MoE(tcfg, torch.float32, "cpu", GEN), p)
    x = _x(rng, 2, 12, jcfg.d_model)
    want, jaux = _jit(jmoe._moe_apply_gspmd)(p, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got, taux = mod(torch.from_numpy(x))
    _close(got, want)
    assert set(taux) == set(jaux)
    for key in jaux:
        _close(taux[key], jaux[key], rtol=1e-5, atol=1e-6)
    if cf < 1:
        assert float(taux["moe_drop_frac"]) > 0
    assert mod.w_router.dtype == torch.float32


# -- recurrent blocks ----------------------------------------------------------

def _state(jstate):
    return {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}


def _prefill_decode(jinit, japply, jstate_init, tmod, tstate_init, jcfg, tcfg, rng, S=11):
    """Prefill S tokens from a zero state, then two decode steps, in both
    packages; every output and state entry is compared."""
    p = jinit(jax.random.PRNGKey(5), jcfg, jnp.float32)
    mod = _load(tmod(tcfg, torch.float32, "cpu", GEN), p)
    japply = _jit(japply, "decode")
    jst = jstate_init(jcfg, 2, jnp.float32)
    tst = tstate_init(tcfg, 2, torch.float32, "cpu")
    for step, n in enumerate((S, 1, 1)):
        x = _x(rng, 2, n, jcfg.d_model)
        jy, jst = japply(p, jnp.asarray(x), jcfg, state=jst, decode=step > 0)
        with torch.no_grad():
            ty, tst = mod(torch.from_numpy(x), state=tst, decode=step > 0)
        _close(ty, jy)
        assert set(tst) == set(jst)
        for key in jst:
            _close(tst[key], jst[key])
    # and without a state (a training forward): the same outputs
    x = _x(rng, 2, S, jcfg.d_model)
    jy, none = japply(p, jnp.asarray(x), jcfg)
    with torch.no_grad():
        ty, tnone = mod(torch.from_numpy(x))
    assert none is None and tnone is None
    _close(ty, jy)


def test_rglru_prefill_and_decode(rng):
    """The doubling scan against the reference's associative_scan: the same
    recurrence associated another way, within the stated tolerance."""
    jcfg, tcfg = _cfgs("recurrentgemma-2b")
    _prefill_decode(jrglru.rglru_init, jrglru.rglru_apply, jrglru.rglru_init_state, trglru.RGLRU,
                    trglru.rglru_init_state, jcfg, tcfg, rng, S=13)


@pytest.mark.parametrize("chunk,S", [(0, 11), (4, 12), (4, 11)])
def test_mlstm_sequential_chunked_and_decode(rng, chunk, S):
    """``mlstm_chunk=4`` takes the chunked form at S=12, the sequential one
    at S=11 (4 does not divide it)."""
    jcfg, tcfg = _cfgs("xlstm-350m", mlstm_chunk=chunk)
    _prefill_decode(jxlstm.mlstm_init, jxlstm.mlstm_apply, jxlstm.mlstm_init_state, txlstm.MLSTM,
                    txlstm.mlstm_init_state, jcfg, tcfg, rng, S=S)


def test_slstm_prefill_and_decode(rng):
    jcfg, tcfg = _cfgs("xlstm-350m")
    _prefill_decode(jxlstm.slstm_init, jxlstm.slstm_apply, jxlstm.slstm_init_state, txlstm.SLSTM,
                    txlstm.slstm_init_state, jcfg, tcfg, rng)


def test_state_dtype_sets_the_cells_outputs(rng):
    """``state_dtype`` rounds a prefill's per-step outputs: bf16 outputs
    agree with the reference's bf16 ones, not with the fp32 ones."""
    jcfg, tcfg = _cfgs("xlstm-350m", state_dtype="bfloat16")
    p = jxlstm.slstm_init(jax.random.PRNGKey(6), jcfg, jnp.float32)
    mod = _load(txlstm.SLSTM(tcfg, torch.float32, "cpu", GEN), p)
    x = _x(rng, 2, 9, jcfg.d_model)
    want, _ = _jit(jxlstm.slstm_apply)(p, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got, _ = mod(torch.from_numpy(x))
        f32, _ = _load(txlstm.SLSTM(dataclasses.replace(tcfg, state_dtype="float32"),
                                    torch.float32, "cpu", GEN), p)(torch.from_numpy(x))
    _close(got, want)
    assert not torch.equal(got, f32)
