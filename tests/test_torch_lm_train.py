"""The LM substrate's training slice in the port against the reference's, on
the CPU: the losses, the seeded data, AdamW (fp32 and 8-bit moments, in the
reference's stacked leaf layout) and SGDM, the train step's loss and
gradients for six families, gradient accumulation, remat, learning, and
``fit`` across a checkpoint.

Weights go across through ``convert.lm_params_from_arrays`` (the
reference's ``model.init(PRNGKey(0))``); inputs are drawn with numpy from a
seed.  The reference's loss, gradients and optimizer updates run under
``jax.jit``, as its ``fit`` runs them (op by op they took minutes).  What
differs is stated where it is tested: XLA fuses multiply-adds and its CPU
square root is not IEEE's (an ulp here and there), and a sum over a
stacked leaf adds in another order than the port's sums over its layers.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.train import data as jdata
from repro.train import losses as jlosses
from repro.train import optimizer as jopt
from repro.train import make_loss_fn as jmake_loss_fn
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import ParamLeaf, build_model, lm_param_leaves
from repro_torch.train import (
    AdamW, SGDM, DataConfig, batch_iterator, cosine_schedule, fit, global_norm, host_batch,
    make_loss_fn, make_train_step, next_token_xent, total_loss,
)
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train.optimizer import flat_params

FAMILIES = ["smollm-135m", "granite-moe-3b-a800m", "recurrentgemma-2b", "xlstm-350m",
            "paligemma-3b", "whisper-small"]
# a leaf's gradient within GRAD_TOL of its largest |g|, that largest floored
# at GRAD_FLOOR of the model's largest: the keys' bias gradient is 0 in exact
# arithmetic (softmax is shift-invariant) and rounding noise near 1e-9 in
# both packages
GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-3
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU ops on one thread: these shapes are tiny, and torch's
    default pool, one thread a core beside the other test workers, spends
    its time waiting for cores (a step of smollm reduced took 0.5-0.9 s on
    8 threads, 0.025 s on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, **over):
    jcfg, cfg = jget(name).reduced(), get_config(name).reduced()
    if name == "xlstm-350m":
        over.setdefault("mlstm_chunk", 4)  # the chunkwise-parallel form
    return dataclasses.replace(jcfg, **over), dataclasses.replace(cfg, **over)


@functools.lru_cache(maxsize=None)
def _pair(name, **over):
    """The reference's model and params for ``name`` reduced, and a
    function that builds the port's model on those params."""
    jcfg, cfg = _cfgs(name, **over)
    jm = jbuild(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    arrays = jax.tree.map(np.asarray, params)

    def port():
        model = build_model(cfg, device="cpu")
        model.load_state_dict(convert.lm_params_from_arrays(cfg, arrays))
        return model

    return jcfg, cfg, jm, params, port


def _batch(cfg, rng, b=B, s=S):
    out = dict(tokens=rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))
    if cfg.encdec:
        out["frames"] = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    if cfg.n_img_tokens:
        out["img_embed"] = rng.normal(size=(b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _stacked(leaf, per_param):
    """The port's per-parameter tensors of ``leaf`` in its reference shape."""
    return np.stack([t.numpy() for t in per_param]) if leaf.stacked else per_param[0].numpy()


def _per_param(state, tree):
    """A reference params-shaped tree of arrays as the list the port's
    optimizer takes (the order of ``flat_params``)."""
    out = []
    for leaf, a in zip(state["leaves"], jax.tree.leaves(tree), strict=True):
        a = np.asarray(a)
        out += [torch.from_numpy(a[g].copy()) for g in range(a.shape[0])] if leaf.stacked \
            else [torch.from_numpy(a.copy())]
    return out


def _leaves_close(got, want, rtol_of_max, floor=0.0):
    for (kp, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                               jax.tree_util.tree_flatten_with_path(got)[0], strict=True):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, jax.tree_util.keystr(kp)
        d = float(np.abs(a.astype(np.float64) - b).max()) if a.size else 0.0
        assert d <= rtol_of_max * max(float(np.abs(a).max()) if a.size else 0.0, floor), \
            (jax.tree_util.keystr(kp), d)


# -- losses ------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("moe", [False, True])
def test_losses_match_the_reference(masked, moe):
    rng = np.random.default_rng(7 + masked + 2 * moe)
    logits = (rng.normal(size=(3, 9, 50)) * 4).astype(np.float32)
    tokens = rng.integers(0, 50, (3, 9)).astype(np.int32)
    tokens[0, 1:] = logits[0, :-1].argmax(-1)  # some right guesses
    mask = (rng.random((3, 9)) < 0.6) if masked else None
    aux = dict(moe_lb_loss=np.float32(1.7), moe_z_loss=np.float32(3.1),
               moe_drop_frac=np.float32(0.25)) if moe else {}
    jl, jm = jlosses.total_loss(jnp.asarray(logits), jnp.asarray(tokens),
                                {k: jnp.asarray(v) for k, v in aux.items()},
                                mask=None if mask is None else jnp.asarray(mask))
    tl, tm = total_loss(torch.from_numpy(logits), torch.from_numpy(tokens),
                        {k: torch.tensor(v) for k, v in aux.items()},
                        mask=None if mask is None else torch.from_numpy(mask))
    assert set(tm) == set(jm)
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-6 * max(abs(float(jm[k])), 1.0), k
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    xl, xm = next_token_xent(torch.from_numpy(logits), torch.from_numpy(tokens))
    assert float(xm["accuracy"]) > 0 and float(xm["tokens"]) == 3 * 8


# -- data ----------------------------------------------------------------------------

@pytest.mark.parametrize("task", ["affine", "uniform"])
@pytest.mark.parametrize("n_hosts", [1, 2])
def test_host_batch_is_the_references_bit_for_bit(task, n_hosts):
    for seed in (1234, -3):
        for vocab, seq in ((101, 16), (49152, 33)):
            for host_id in range(n_hosts):
                kw = dict(vocab_size=vocab, seq_len=seq, global_batch=4, task=task, seed=seed,
                          n_hosts=n_hosts, host_id=host_id)
                for step in (5, 2**31 + 7):
                    want = np.asarray(jdata.host_batch(jdata.DataConfig(**kw), step)["tokens"])
                    got = host_batch(DataConfig(**kw), step)["tokens"]
                    assert got.dtype == torch.int32 and got.device.type == "cpu"
                    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("span", [101, 512, 49152, 70001, 2**31 - 2])
def test_randint_is_jax_randint(span):
    """Two words from the halves of a split, folded by the span's
    multiplier: non-power-of-two spans and spans whose products wrap in
    uint32."""
    for seed in (0, 9):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
        want = np.asarray(jax.random.randint(key, (5, 37), 1, 1 + span, jnp.int32))
        got = tdata.randint(tuple(int(x) for x in np.asarray(key)), (5, 37), 1, 1 + span)
        np.testing.assert_array_equal(got.numpy(), want)
    k = jax.random.PRNGKey(4)
    assert tdata.split(tuple(int(x) for x in np.asarray(k)), 3) == tuple(
        tuple(int(x) for x in row) for row in np.asarray(jax.random.split(k, 3)))


def test_batch_iterator_starts_where_asked():
    dc = DataConfig(vocab_size=101, seq_len=8, global_batch=2)
    it = batch_iterator(dc, start_step=4)
    step, batch = next(it)
    assert step == 4 and torch.equal(batch["tokens"], host_batch(dc, 4)["tokens"])
    with pytest.raises(ValueError):
        host_batch(DataConfig(vocab_size=101, seq_len=8, global_batch=3, n_hosts=2), 0)


# -- optimizer ---------------------------------------------------------------------

def _opt_case(name, **over):
    """The reference's params tree and the port's model on it, and three
    gradient trees drawn from a seed."""
    jcfg, cfg, jm, params, port = _pair(name, **over)
    rng = np.random.default_rng(11)
    grads = [jax.tree.map(lambda p: jnp.asarray(
        (rng.normal(size=p.shape) * 10.0 ** rng.uniform(-3, 0)).astype(np.float32)), params)
        for _ in range(3)]
    return cfg, params, port(), grads


OPT_CASES = {  # decay and clipping off at a constant lr; both on under the schedule
    "plain": dict(lr=1e-2, weight_decay=0.0, clip_norm=None),
    "decay_clip_cosine": dict(lr="cosine", weight_decay=0.1, clip_norm=1.0),
}


def _lr(kw, mod):
    if kw.get("lr") == "cosine":
        return dict(kw, lr=mod.cosine_schedule(2e-2, 2, 10))
    return kw


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_adamw_fp32_matches_the_reference(case):
    """One and three updates on the same gradients from the same state:
    the moments within 1e-6 of their leaf's largest, the parameters within
    2^-21 (four ulps at magnitude 1; XLA's CPU square root and the gradient
    norm's order of summation), in the stacked leaf layout (recurrentgemma
    at 8 layers: stacked 2-D norms decayed, rest layers' 1-D leaves not)."""
    cfg, params, model, grads = _opt_case("recurrentgemma-2b", n_layers=8)
    kw = OPT_CASES[case]
    jo, to = jopt.AdamW(**_lr(kw, jopt)), AdamW(**_lr(kw, topt))
    js, ts = jo.init(params), to.init(lm_param_leaves(cfg, model))
    assert [leaf.name for leaf in ts["leaves"]] == [
        jax.tree_util.keystr(kp) for kp, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    jp, jupdate = params, jax.jit(jo.update)
    for i, g in enumerate(grads):
        jp, js, jm = jupdate(g, js, jp)
        ts, tm = to.update(_per_param(ts, g), ts)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-6 * float(jm["grad_norm"])
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        if i in (0, 2):
            _leaves_close(convert.lm_params_to_arrays(cfg, model), jp, 2.0**-21, floor=1.0)
            got = convert.lm_opt_state_to_arrays(cfg, ts)
            assert int(got["count"]) == int(js["count"]) == i + 1
            for key in ("m", "v"):
                _leaves_close(got[key], js[key], 1e-6)


@pytest.mark.parametrize("name,over", [
    ("recurrentgemma-2b", dict(n_layers=8)),  # stacked 2-D norms, per-slice blocks, rest layers
    ("granite-moe-3b-a800m", dict(layer_stack="unroll")),  # rest MoE leaves (E, d, ff): per expert
])
def test_adamw_8bit_matches_the_reference(name, over):
    """Three updates with 8-bit moments: the reference's block layout leaf
    for leaf (``q`` int8 ``(L, NB, 128)``, ``scale`` ``(L, NB, 1)``); ``q``
    equal but at rounding ties (at most 4 entries in the whole state, each
    one step apart; 1 of 752,384 and 0 of 510,208 here) and ``scale`` within
    2.4e-7 relative, two fp32 ulps (XLA's fused multiply-adds in the
    moments, carried into the next steps' blocks).  The port takes
    ``absmax * fp32(1/127)``, as XLA compiles the reference's
    ``absmax / 127.0``."""
    cfg, params, model, grads = _opt_case(name, **over)
    # no clipping: the clip's scale would carry the gradient norm's order of
    # summation into every moment
    kw = dict(lr=1e-2, quantize_moments=True, clip_norm=None)
    jo, to = jopt.AdamW(**kw), AdamW(**kw)
    js, ts = jo.init(params), to.init(lm_param_leaves(cfg, model))
    jp, jupdate = params, jax.jit(jo.update)
    for g in grads:
        jp, js, _ = jupdate(g, js, jp)
        ts, _ = to.update(_per_param(ts, g), ts)
    got = convert.lm_opt_state_to_arrays(cfg, ts)
    want = jax.tree.map(np.asarray, js)
    n_diff = 0
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(k) for k, _ in flat_w] == [
        jax.tree_util.keystr(k) for k, _ in flat_g]
    for (kp, a), (_, b) in zip(flat_w, flat_g):
        assert a.shape == b.shape and a.dtype == b.dtype, jax.tree_util.keystr(kp)
        if a.dtype == np.int8:
            d = np.abs(a.astype(np.int32) - b)
            assert d.max() <= 1
            n_diff += int((d > 0).sum())
        elif a.ndim:
            np.testing.assert_allclose(b, a, rtol=2.4e-7, atol=0)
        else:
            assert int(a) == int(b) == 3  # the count
    assert n_diff <= 4, n_diff
    # the blocks straddle layers where the reference flattens a stacked 2-D leaf
    shapes = {leaf.name: (leaf.shape, m["q"].shape) for leaf, m in zip(ts["leaves"], ts["m"])}
    if name == "recurrentgemma-2b":
        assert shapes["['groups'][0]['ln1']['scale']"] == ((2, 64), (1, 1, 128))
        assert shapes["['groups'][0]['mlp']['w_in']['w']"] == ((2, 64, 128), (2, 64, 128))
    else:
        assert shapes["['rest'][0]['mlp']['experts_in']"] == ((4, 64, 128), (4, 64, 128))


def test_sgdm_matches_the_reference():
    cfg, params, model, grads = _opt_case("smollm-135m")
    jo, to = jopt.SGDM(lr=5e-2), SGDM(lr=5e-2)
    js, ts = jo.init(params), to.init(lm_param_leaves(cfg, model))
    jp, jupdate = params, jax.jit(jo.update)
    for g in grads:
        jp, js, _ = jupdate(g, js, jp)
        ts, _ = to.update(_per_param(ts, g), ts)
    _leaves_close(convert.lm_params_to_arrays(cfg, model), jp, 2.0**-21, floor=1.0)
    _leaves_close(convert.lm_opt_state_to_arrays(cfg, ts)["mu"], js["mu"], 1e-6)


def _dict_leaves(tensors):
    """A dict of named tensors as optimizer leaves: one unstacked leaf a
    key, in the order jax flattens a dict (sorted keys)."""
    return [ParamLeaf((k,), tuple(t.shape), [t], False) for k, t in sorted(tensors.items())]


def test_the_references_optimizer_cases():
    """The reference's own optimizer tests (``tests/test_optimizer.py``)
    on the port: the closed-form first step, decay only on matrices, the
    clip's norm, the schedule's shape, the 8-bit round trip's bound, 8-bit
    AdamW tracking fp32, SGDM descending."""
    opt = AdamW(lr=1e-2, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0, clip_norm=None)
    p = {"w": torch.tensor([[1.0, -2.0], [0.5, 3.0]])}
    g = torch.tensor([[0.1, -0.2], [0.3, 0.4]])
    w0 = p["w"].clone()
    opt.update([g], opt.init(_dict_leaves(p)))
    torch.testing.assert_close(p["w"], w0 - 1e-2 * g / (g.abs() + 1e-8), rtol=1e-5, atol=0)

    p = {"w": torch.ones((2, 2)), "b": torch.ones(2)}
    AdamW(lr=1e-2, weight_decay=0.5, clip_norm=None).update(
        [torch.zeros(2), torch.zeros((2, 2))], AdamW(weight_decay=0.5).init(_dict_leaves(p)))
    assert float((p["w"] - 1).abs().max()) > 0 and torch.equal(p["b"], torch.ones(2))

    _, m = AdamW(lr=1e-3, clip_norm=1.0).update(
        [torch.full((4,), 100.0)], AdamW().init(_dict_leaves({"w": torch.zeros(4)})))
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    assert float(global_norm([torch.full((4,), 3.0), torch.full((9,), 1.0)])) == \
        pytest.approx(float(np.sqrt(45.0)))

    lr = cosine_schedule(1.0, warmup=10, total=110, floor=0.1)
    assert float(lr(0)) == 0.0 and float(lr(5)) == pytest.approx(0.5)
    assert float(lr(10)) == pytest.approx(1.0) and float(lr(110)) == pytest.approx(0.1, abs=1e-3)

    rng = np.random.default_rng(0)
    for n in (1, 127, 128, 300):
        x = (rng.normal(size=n) * 10 ** rng.uniform(-4, 2)).astype(np.float32)
        y = topt._q8_dequantize(topt._q8_quantize(torch.from_numpy(x)), (n,)).numpy()
        scale = np.abs(np.pad(x, (0, (-n) % 128)).reshape(-1, 128)).max(1) / 127.0
        assert (np.abs(y - x) <= np.repeat(scale, 128)[:n] * 0.5 + 1e-9).all()
        want = jopt._q8_quantize(jnp.asarray(x))
        got = topt._q8_quantize(torch.from_numpy(x))
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
        np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))

    losses = []
    for q in (False, True):
        w = {"w": torch.zeros(256)}
        o = AdamW(lr=5e-2, clip_norm=None, quantize_moments=q)
        s = o.init(_dict_leaves(w))
        for _ in range(60):
            s, _ = o.update([2 * (w["w"] - 3.0)], s)
        losses.append(float(((w["w"] - 3.0) ** 2).sum()))
    assert losses[1] < 0.1 * 9 * 256 and abs(losses[0] - losses[1]) / max(losses[0], 1e-3) < 2.0

    w = {"w": torch.zeros(8)}
    o = SGDM(lr=0.1)
    s = o.init(_dict_leaves(w))
    for _ in range(20):
        s, _ = o.update([2 * (w["w"] - 1.0)], s)
    assert float(((w["w"] - 1.0) ** 2).sum()) < 0.05 * 8


# -- the train step --------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jit_grads(name):
    jcfg, cfg, jm, params, port = _pair(name)
    return jax.jit(jax.value_and_grad(jmake_loss_fn(jm, jcfg), has_aux=True))


@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_loss_and_gradients_match_the_reference(name):
    """The loss, its metrics (the MoE's aux among them) and every gradient
    against ``jax.value_and_grad`` of the reference's ``make_loss_fn``; then
    one ``make_train_step`` (AdamW) moves every parameter of the port."""
    jcfg, cfg, jm, params, port = _pair(name)
    batch = _batch(cfg, np.random.default_rng(sum(map(ord, name))))
    (jl, jmet), jg = _jit_grads(name)(params, _j(batch))
    model = port()
    state = AdamW(lr=1e-3).init(lm_param_leaves(cfg, model))
    loss, met = make_loss_fn(model, cfg)(_t(batch))
    grads = torch.autograd.grad(loss, flat_params(state), allow_unused=True,
                                materialize_grads=True)
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    assert set(met) == set(jmet)
    for k in jmet:
        want = float(jmet[k])
        assert abs(float(met[k].detach()) - want) <= 1e-5 * max(abs(want), 1.0), k
    it = iter(grads)
    got = [_stacked(leaf, [next(it).detach() for _ in leaf.params]) for leaf in state["leaves"]]
    floor = GRAD_FLOOR * max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(jg))
    _leaves_close(jax.tree.unflatten(jax.tree.structure(jg), got), jg, GRAD_TOL, floor=floor)
    if cfg.moe:  # the aux losses reach the router
        router = [g for leaf, g in zip(state["leaves"], got) if "w_router" in leaf.name]
        assert router and all(np.abs(r).max() > 0 for r in router)
    before = [p.detach().clone() for p in flat_params(state)]
    state, metrics = make_train_step(model, cfg, AdamW(lr=1e-3))(state, _t(batch))
    assert all(not torch.equal(a, b) for a, b in zip(before, flat_params(state)))
    assert int(state["count"]) == 1


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_arch_trains_a_step(name):
    """The port alone, every arch reduced: a step of AdamW with 8-bit
    moments, the loss finite, every parameter moved."""
    cfg = get_config(name).reduced()
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    opt = AdamW(lr=1e-3, quantize_moments=True)
    state = opt.init(lm_param_leaves(cfg, model))
    before = [p.detach().clone() for p in flat_params(state)]
    step = make_train_step(model, cfg, opt)
    batch = _t(_batch(cfg, np.random.default_rng(3), s=8))
    state, metrics = step(state, batch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert all(not torch.equal(a, b) for a, b in zip(before, flat_params(state)))


def test_grad_accum_matches_one_batch():
    """``grad_accum=4`` against 1 on the same batch, at the reference's
    tolerance (``tests/test_train_serve.py:42``)."""
    jcfg, cfg, jm, params, port = _pair("smollm-135m")
    batch = host_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8), 0)
    out = []
    for ga in (1, 4):
        model = port()
        opt = AdamW(lr=1e-3, clip_norm=None)
        state = opt.init(lm_param_leaves(cfg, model))
        state, _ = make_train_step(model, cfg, opt, grad_accum=ga)(state, batch)
        out.append([p.detach() for p in flat_params(state)])
    for a, b in zip(*out):
        torch.testing.assert_close(b, a, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("name", ["smollm-135m", "granite-moe-3b-a800m"])
def test_remat_gives_the_same_gradients(name):
    """``cfg.remat`` checkpoints each group of ``P`` layers: the gradients
    (the router's through the MoE aux losses too) equal those without."""
    _, cfg, _, _, port = _pair(name)
    batch = _t(_batch(cfg, np.random.default_rng(5)))
    out = []
    for remat in (False, True):
        model = port()
        model.cfg = dataclasses.replace(cfg, remat=remat)
        loss, _ = make_loss_fn(model, model.cfg)(batch)
        out.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_loss_decreases():
    """The reference's ``test_loss_decreases``: 50 steps on the affine
    task, the mean of the last 5 losses under half the first."""
    cfg = get_config("smollm-135m").reduced()
    model = build_model(cfg, device="cpu")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)
    opt = AdamW(lr=2e-3, weight_decay=0.0)
    step = make_train_step(model, cfg, opt)
    state = opt.init(lm_param_leaves(cfg, model))
    losses = []
    for s, batch in batch_iterator(dc):
        if s >= 50:
            break
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < 0.5 * losses[0], (losses[0], losses[-5:])


def test_fit_resumed_from_a_checkpoint_continues_the_straight_run(tmp_path):
    """The reference's continuity test: 6 steps straight with a checkpoint
    at step 3, then a fresh model restored from step 3 runs steps 3-5; the
    parameters agree at the reference's tolerance."""
    from repro_torch.io import CheckpointManager

    _, cfg, _, _, port = _pair("smollm-135m")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    opt = AdamW(lr=1e-3)
    cm = CheckpointManager(str(tmp_path), async_write=False)
    model_a = port()
    pa, _, _ = fit(model_a, cfg, opt, batch_iterator(dc), steps=6, ckpt_manager=cm,
                   ckpt_every=3, log_every=0)
    model_b = port()
    like = convert.lm_train_tree(cfg, model_b, opt.init(lm_param_leaves(cfg, model_b)),
                                 like=True)
    tree, step = cm.restore(step=3, like=like)
    assert step == 3
    state = convert.lm_opt_state_from_arrays(cfg, model_b, tree["opt_state"])
    assert int(state["count"]) == 3
    pb, _, _ = fit(model_b, cfg, opt, batch_iterator(dc, start_step=3), steps=6,
                   params=convert.lm_params_from_arrays(cfg, tree["params"]),
                   opt_state=state, log_every=0)
    for k in pa:
        torch.testing.assert_close(pb[k], pa[k], rtol=1e-5, atol=1e-6)
