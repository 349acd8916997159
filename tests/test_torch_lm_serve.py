"""The LM substrate's serving path in the port against the reference's, on
the CPU: all ten archs ``reduced()``, their prefill, decode and greedy
generation, ROADMAP F10, the CLI and the port's own init.

For each arch the reference's params (``model.init(PRNGKey(0))``) go
through ``convert.lm_params_from_arrays`` into the port's model; the inputs
are made with numpy from a seed.  The reference runs ``model.apply`` under
``jax.jit``, a prefill and then decode steps as its own smoke test steps
them (``tests/test_models_smoke.py:68-102``) and as its ``greedy_generate``
runs them, and ``greedy_generate`` under its own ``jax.jit``.  Logits, caches and
recurrent states agree within atol 1e-4 and rtol 1e-4 in fp32; greedy
tokens are equal.
"""
import ast
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.train import greedy_generate as jgreedy
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model
from repro_torch.train import greedy_generate, make_prefill_fn, make_serve_step

TOL = dict(rtol=1e-4, atol=1e-4)
ALL = sorted(ARCHS)
B, S, NEW = 2, 16, 4


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **TOL)


def _flat(cache):
    """A cache's tensors by name: ``layer.key`` for a decoder's list."""
    if isinstance(cache, dict):
        return dict(cache)
    return {f"{i}.{k}": v for i, layer in enumerate(cache) for k, v in layer.items()}


def _close_caches(tcache, jcache, cfg):
    want = _flat(convert.lm_cache_from_arrays(cfg, jax.tree.map(np.asarray, jcache)))
    got = _flat(tcache)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        _close(got[key], want[key].numpy())


def test_the_registry_is_the_reference_value_for_value():
    assert sorted(JARCHS) == ALL
    for name in ALL:
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jget(name))
        assert dataclasses.asdict(get_config(name).reduced()) == \
            dataclasses.asdict(jget(name).reduced())
        assert get_config(name).n_params() == jget(name).n_params()


@functools.lru_cache(maxsize=None)
def _built(name):
    """``name`` reduced in both packages: the reference's model and params
    (``init(PRNGKey(0))``), the port's model on them, and the reference's
    ``apply`` under ``jax.jit`` for a prefill (or a cache-free forward) and
    for a decode step."""
    jcfg, cfg = jget(name).reduced(), get_config(name).reduced()
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(convert.lm_params_from_arrays(cfg, jax.tree.map(np.asarray, params)))
    prefill = jax.jit(lambda p, toks, cache, kw: jm.apply(p, toks, cache=cache, **kw))
    step = jax.jit(lambda p, tok, cache, pos: jm.apply(p, tok, cache=cache, cache_pos=pos))
    return jcfg, cfg, jm, params, model, prefill, step


@pytest.fixture(scope="module", params=ALL)
def arch(request):
    """One arch in both packages: the reference's params, the port's model
    on them, the inputs, and the reference's prefill, two decode steps and
    greedy tokens."""
    name = request.param
    jcfg, cfg, jm, params, model, jprefill, jstep = _built(name)
    rng = np.random.default_rng(sum(map(ord, name)))
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jkw, tkw = {}, {}
    n_img = cfg.n_img_tokens or 0
    if cfg.encdec:
        frames = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        jkw["frames"], tkw["frames"] = jnp.asarray(frames), torch.from_numpy(frames)
        jcache = jm.init_cache(B, S + 2, S)
        new_cache = lambda: model.init_cache(B, S + 2, S)
    else:
        if n_img:
            img = rng.normal(size=(B, n_img, cfg.d_model)).astype(np.float32)
            jkw["img_embed"], tkw["img_embed"] = jnp.asarray(img), torch.from_numpy(img)
        jcache = jm.init_cache(B, S + 2 + n_img)
        new_cache = lambda: model.init_cache(B, S + 2 + n_img)
    ref = dict(cfg=cfg, model=model, toks=toks, tkw=tkw, new_cache=new_cache)
    logits, jcache, _ = jprefill(params, jnp.asarray(toks), jcache, jkw)
    ref["prefill"] = (np.asarray(logits), jax.tree.map(np.asarray, jcache))
    steps = []
    for i in range(2):
        nxt = np.asarray(jnp.argmax(logits[:, -1], -1)).astype(np.int32)[:, None]
        logits, jcache, _ = jstep(params, jnp.asarray(nxt), jcache,
                                  jnp.asarray(S + n_img + i, jnp.int32))
        steps.append((nxt, np.asarray(logits), jax.tree.map(np.asarray, jcache)))
    ref["steps"] = steps
    extras = dict(jkw) or None
    cache_len = S + NEW + n_img if n_img else None
    ref["greedy"] = np.asarray(jgreedy(jm, jcfg, params, jnp.asarray(toks[:, :8]), NEW,
                                       extras=extras, cache_len=cache_len))
    ref["greedy_args"] = (torch.from_numpy(toks[:, :8].copy()), dict(tkw) or None, cache_len)
    return ref


def test_prefill_logits_and_cache(arch):
    cfg = arch["cfg"]
    with torch.no_grad():
        logits, cache, aux = arch["model"](torch.from_numpy(arch["toks"]),
                                           cache=arch["new_cache"](), **arch["tkw"])
    want_logits, want_cache = arch["prefill"]
    assert logits.shape == want_logits.shape
    _close(logits, want_logits)
    _close_caches(cache, want_cache, cfg)
    assert set(aux) == ({"moe_lb_loss", "moe_z_loss", "moe_drop_frac"} if cfg.moe else set())


def test_two_decode_steps(arch):
    """After the prefill (the same cache object, written in place), two
    decode steps at ``S + n_img`` and one past it, as the reference's smoke
    test steps them."""
    cfg, cache = arch["cfg"], arch["new_cache"]()
    n_img = cfg.n_img_tokens or 0
    with torch.no_grad():
        arch["model"](torch.from_numpy(arch["toks"]), cache=cache, **arch["tkw"])
        for i, (nxt, want_logits, want_cache) in enumerate(arch["steps"]):
            pos = torch.tensor(S + n_img + i, dtype=torch.int32)
            logits, cache, _ = arch["model"](torch.from_numpy(nxt), cache=cache, cache_pos=pos)
            assert logits.shape == (B, 1, cfg.vocab_size)
            _close(logits, want_logits)
            _close_caches(cache, want_cache, cfg)


def test_greedy_generate_tokens_equal(arch):
    prompt, extras, cache_len = arch["greedy_args"]
    out = greedy_generate(arch["model"], arch["cfg"], prompt, NEW, extras=extras,
                          cache_len=cache_len)
    assert out.dtype == torch.int32 and out.shape == (B, NEW)
    np.testing.assert_array_equal(out.numpy(), arch["greedy"])


def test_f10_vlm_decode_position_in_both_packages():
    """ROADMAP F10: ``greedy_generate`` decodes at ``S + i`` although the
    VLM's prefill cached ``n_img + S`` slots.  One decode step at ``S``
    differs from a cache-free forward over the same tokens; at ``S + n_img``
    it agrees; the two packages agree on both.  The shapes are the arch
    fixture's, so the reference's jitted prefill and step are reused."""
    jcfg, cfg, jm, params, model, jprefill, jstep = _built("paligemma-3b")
    rng = np.random.default_rng(10)
    n_img, s = cfg.n_img_tokens, S
    toks = rng.integers(0, cfg.vocab_size, (B, s + 1)).astype(np.int32)
    img = rng.normal(size=(B, n_img, cfg.d_model)).astype(np.float32)
    jfull, _, _ = jprefill(params, jnp.asarray(toks), None, dict(img_embed=jnp.asarray(img)))
    with torch.no_grad():
        tfull, _, _ = model(torch.from_numpy(toks), img_embed=torch.from_numpy(img))
    _close(tfull[:, -1], np.asarray(jfull)[:, -1])
    gaps = {}
    for pos in (s, s + n_img):
        jc = jm.init_cache(B, s + n_img + 2)
        _, jc, _ = jprefill(params, jnp.asarray(toks[:, :s]), jc, dict(img_embed=jnp.asarray(img)))
        jl, _, _ = jstep(params, jnp.asarray(toks[:, s:]), jc, jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            tc = model.init_cache(B, s + n_img + 2)
            model(torch.from_numpy(toks[:, :s]), img_embed=torch.from_numpy(img), cache=tc)
            tl, _, _ = model(torch.from_numpy(toks[:, s:]), cache=tc,
                             cache_pos=torch.tensor(pos, dtype=torch.int32))
        _close(tl, jl)
        gaps[pos] = (float((tl[:, 0] - tfull[:, -1]).abs().max()),
                     float(np.abs(np.asarray(jl)[:, 0] - np.asarray(jfull)[:, -1]).max()))
    assert min(gaps[s]) > 1.0, gaps  # the defect, in both packages
    assert max(gaps[s + n_img]) < 1e-4, gaps


def test_prefill_and_serve_step_functions():
    """``make_prefill_fn`` returns the cache and the last logits;
    ``make_serve_step`` one token's logits; the step equals a model call."""
    cfg = get_config("recurrentgemma-2b").reduced()
    model = build_model(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (B, 9)))
    cache, last = make_prefill_fn(model, cfg, cache_len=12)(toks)
    with torch.no_grad():
        full, _, _ = model(toks)
    torch.testing.assert_close(last, full[:, -1], **TOL)
    step = make_serve_step(model, cfg)
    nxt = last.argmax(-1).to(torch.int32)[:, None]
    logits, cache = step(cache, nxt, torch.tensor(9, dtype=torch.int32))
    with torch.no_grad():
        full, _, _ = model(torch.cat([toks, nxt.long()], 1))
    assert logits.shape == (B, cfg.vocab_size)
    torch.testing.assert_close(logits, full[:, -1], **TOL)


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "whisper-small"])
def test_sampling_is_deterministic_under_one_generator(name):
    cfg = get_config(name).reduced()
    model = build_model(cfg, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (B, 6)))
    extras = dict(frames=torch.ones((B, 6, cfg.d_model))) if cfg.encdec else None
    # a high temperature: random weights give peaked logits
    runs = [greedy_generate(model, cfg, prompt, 5, extras=extras, temperature=1e4, seed=s)
            for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < cfg.vocab_size


def test_the_ports_init_is_deterministic_and_sized_as_the_reference():
    """The port draws its own parameters from one ``torch.Generator``: the
    same seed gives the same tensors, another seed others; every arch holds
    exactly the reference's parameter count."""
    for name in ALL:
        cfg = get_config(name).reduced()
        a = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
        want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
            jax.eval_shape(jbuild(jget(name).reduced()).init, jax.random.PRNGKey(0))))
        assert sum(p.numel() for p in a.parameters()) == want, name
        if name in ("xlstm-350m", "recurrentgemma-2b", "whisper-small"):
            b = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
            c = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(8))
            sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
            assert all(torch.equal(sa[k], sb[k]) for k in sa)
            assert not all(torch.equal(sa[k], sc[k]) for k in sa)


def test_build_model_takes_the_card_unless_given_a_device():
    cfg = get_config("smollm-135m").reduced()
    if torch.cuda.is_available():
        assert build_model(cfg).emb.embed.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
    assert build_model(cfg, device="cpu").emb.embed.device.type == "cpu"


@pytest.mark.parametrize("name", ["xlstm-350m", "whisper-small", "paligemma-3b"])
def test_the_serve_cli_runs_on_the_cpu(capsys, name):
    assert serve_cli.main(["--device", "cpu", "--arch", name, "--batch", "2",
                           "--prompt-len", "5", "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert f"{name} on cpu" in out and "generated 6 tokens" in out
    first = ast.literal_eval(out.split("first sequence:")[1].strip())
    assert len(first) == 3
