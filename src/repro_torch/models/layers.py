"""Foundational model layers, the counterpart of ``repro/models/layers.py``.

Each part with parameters is an ``nn.Module`` whose parameter names are the
reference's pytree keys (``Dense.w``/``.b``, ``Norm.scale``/``.nbias``, ...),
so ``convert.lm_params_from_arrays`` maps a reference tree onto a
``state_dict`` key by key; the rest are plain functions on tensors.

Conventions, as in the reference:
  * parameters are stored in ``cfg.param_dtype``; the compute casts to
    ``cfg.compute_dtype``; norms, rope's angles, the attention scores, the
    softmax and the PV product run in fp32;
  * attention projections are flattened ``(d, H*hd)`` weights, and query
    head ``h`` reads kv head ``h // G`` through the ``(B, Sq, KV, G, hd)``
    reshape (GQA);
  * masks add ``-1e30``, never ``-inf``, so a fully masked row softmaxes to
    a uniform row instead of NaN.

Caches are written in place (``index_copy_`` at a device index), and a
decode step reads its position from a 0-d device tensor: nothing in a step
reads a value back to the host.

The reference's sharding hints are here at its call sites:
``sharding.policy.constrain`` redistributes a DTensor activation to its
kind's spec under a policy, and is the identity without one (one card, no
policy: no op added).  Under a policy the parameters and inputs are
DTensors and DTensor's sharding propagation plays GSPMD's part; a cache
write that is not the whole cache, which DTensor has no in-place layout
for, takes a masked ``where`` (a decode step) or
``sharding.policy.replicated`` (a prefill into a longer or ring cache),
then ``assign_`` writes the result into the cache in its own layout.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..sharding.policy import assign_, attend, constrain, dense, embedding, replicated, split_last

NEG = -1e30  # the reference's mask value


def dtype_of(name: str) -> torch.dtype:
    """``cfg.param_dtype`` / ``cfg.compute_dtype`` as a torch dtype."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def trunc_normal(shape, scale, dtype, device, generator) -> torch.Tensor:
    """``scale * truncated_normal(-2, 2)`` drawn in f32 from ``generator``,
    then cast to ``dtype`` (the reference's ``layers._init``)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t.mul_(scale)).to(dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class Dense(nn.Module):
    """``y = x @ w (+ b)`` in the compute dtype."""

    def __init__(self, d_in, d_out, dtype, device, generator, bias=False, scale=None):
        super().__init__()
        scale = scale if scale is not None else d_in ** -0.5
        self.w = nn.Parameter(trunc_normal((d_in, d_out), scale, dtype, device, generator))
        if bias:
            self.b = nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device))
        else:
            self.register_parameter("b", None)

    def forward(self, x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
        y = dense(x.to(cdt), self.w.to(cdt))
        if self.b is not None:
            y = y + self.b.to(cdt)
        return y


class Norm(nn.Module):
    """rmsnorm (eps 1e-6) or layernorm (eps 1e-5), computed in fp32 and
    returned in the input's dtype."""

    def __init__(self, kind: str, d: int, dtype, device):
        super().__init__()
        self.kind = kind
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        if kind == "layernorm":
            self.nbias = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))
        else:
            self.register_parameter("nbias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.kind == "rmsnorm":
            y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
        else:
            mu = torch.mean(xf, dim=-1, keepdim=True)
            var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
            y = (xf - mu) * torch.rsqrt(var + 1e-5)
        y = y * self.scale.float()
        if self.nbias is not None:
            y = y + self.nbias.float()
        return y.to(x.dtype)


# -- rotary embeddings -------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd), positions: (B, S) or (S,).  The half split
    (``x[..., :half]``, ``x[..., half:]``), angles in fp32."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freq  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


# -- attention ---------------------------------------------------------------

def mask_bias(qpos, kpos, causal, window, prefix_len) -> torch.Tensor:
    """(Sq, Sk) additive f32 bias: 0 allowed, -1e30 masked."""
    q = qpos[:, None]
    k = kpos[None, :]
    allowed = torch.ones((q.shape[0], k.shape[1]), dtype=torch.bool, device=qpos.device)
    if causal:
        allowed = k <= q
        if prefix_len:
            allowed = allowed | ((q < prefix_len) & (k < prefix_len))
    if window:
        allowed = allowed & (k > q - window)
    return torch.where(allowed, 0.0, NEG).float()


def sdpa(q, k, v, *, causal, window=0, prefix_len=0, k_valid=None):
    """Full (unblocked) scaled dot-product attention with GQA.

    q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd).  fp32 scores and softmax.
    ``k_valid``: the number of valid cache slots (decode), a 0-d tensor."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qh = q.reshape(B, Sq, KV, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qh.float(), k.float()) * (hd ** -0.5)
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    scores = scores + mask_bias(qpos, kpos, causal, window, prefix_len)
    if k_valid is not None:
        scores = torch.where(kpos < k_valid, scores, NEG)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def chunked_attention(q, k, v, *, causal, window=0, prefix_len=0, block_q=512, block_k=1024):
    """Flash-style online-softmax attention over query and key blocks: no
    (S, S) score matrix.

    The result keeps the reference's layout bit for bit in the order of its
    axes: its last step reshapes the ``(B, nq, KV, G, block_q, hd)`` blocks
    straight to ``(B, nq * block_q, H, hd)`` with no transpose
    (``repro/models/layers.py:200``), which mixes heads and query positions
    whenever ``H > 1``.  The port keeps that reference behaviour for parity
    (ROADMAP F11); with one head it equals :func:`sdpa`."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    block_q = min(block_q, Sq)
    block_k = min(block_k, Sk)
    pad_q = (-Sq) % block_q
    pad_k = (-Sk) % block_k
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq, nk = (Sq + pad_q) // block_q, (Sk + pad_k) // block_k
    qs = q.reshape(B, nq, block_q, KV, G, hd).float()
    ks = k.reshape(B, nk, block_k, KV, hd).float()
    vs = v.reshape(B, nk, block_k, KV, hd).float()
    scale = hd ** -0.5
    dev = q.device
    outs = []
    for qi in range(nq):
        q_blk = qs[:, qi]
        qpos = qi * block_q + torch.arange(block_q, device=dev)
        m = torch.full((B, KV, G, block_q), NEG, device=dev)
        l = torch.zeros((B, KV, G, block_q), device=dev)
        acc = torch.zeros((B, KV, G, block_q, hd), device=dev)
        for ki in range(nk):
            kpos = ki * block_k + torch.arange(block_k, device=dev)
            s = torch.einsum("bqkgh,bskh->bkgqs", q_blk, ks[:, ki]) * scale
            s = s + mask_bias(qpos, kpos, causal, window, prefix_len) \
                + torch.where(kpos < Sk, 0.0, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p, vs[:, ki])
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])  # (B, KV, G, block_q, hd)
    out = torch.stack(outs, dim=1).reshape(B, nq * block_q, KV * G, hd)
    return out[:, :Sq].to(q.dtype)


def prefill_cache_write(k: torch.Tensor, cache_k: torch.Tensor, window: int) -> torch.Tensor:
    """Write prefilled keys/values into a cache in place and return it.  A
    windowed (ring) cache keeps the last ``Sc`` entries at ``pos % Sc``."""
    S, Sc = k.shape[1], cache_k.shape[1]
    if isinstance(cache_k, DTensor):
        if not window and S == Sc:
            return assign_(cache_k, k)
        new = replicated("prefill_cache_write",
                         lambda k, c: prefill_cache_write(k, c.clone(), window), k, cache_k)
        return assign_(cache_k, new)
    if not window:
        if S > Sc:
            raise ValueError(f"a prefill of {S} tokens does not fit a cache of {Sc} slots")
        cache_k[:, :S].copy_(k)
        return cache_k
    tail = k[:, -Sc:] if S > Sc else k
    start = max(S - Sc, 0)
    slots = (start + torch.arange(tail.shape[1], device=k.device)) % Sc
    return cache_k.index_copy_(1, slots, tail.to(cache_k.dtype))


def decode_cache_write(k: torch.Tensor, cache_k: torch.Tensor, cache_pos: torch.Tensor,
                       window: int) -> torch.Tensor:
    """Write one token's key/value at ``cache_pos`` in place: the ring slot
    ``pos % Sc`` of a windowed cache, else the slot the reference's
    ``dynamic_update_slice`` takes, ``pos`` clamped to ``[0, Sc - 1]``."""
    Sc = cache_k.shape[1]
    slot = torch.remainder(cache_pos, Sc) if window else torch.clamp(cache_pos, 0, Sc - 1)
    if isinstance(cache_k, DTensor):  # a mask over the slots: no collective
        hit = (torch.arange(Sc, device=slot.device) == slot).reshape(1, Sc, 1, 1)
        return assign_(cache_k, torch.where(hit, k.to(cache_k.dtype), cache_k))
    return cache_k.index_copy_(1, slot.reshape(1).long(), k.to(cache_k.dtype))


class Attention(nn.Module):
    """Self or cross attention with an optional KV cache (``wq``, ``wk``,
    ``wv``, ``wo``)."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        self.cfg = cfg
        d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        mk = lambda d_in, d_out, **kw: Dense(d_in, d_out, dtype, device, generator, **kw)
        self.wq = mk(d, H * hd, bias=cfg.qkv_bias)
        self.wk = mk(d, KV * hd, bias=cfg.qkv_bias)
        self.wv = mk(d, KV * hd, bias=cfg.qkv_bias)
        self.wo = mk(H * hd, d, scale=(H * hd) ** -0.5)

    def forward(self, x, *, positions, causal=True, window=0, prefix_len=0,
                cache: Optional[Dict] = None, cache_pos=None, kv_source=None, cross=False):
        """Three cache modes, as the reference's ``attention_apply``:
          * prefill (cache given, ``cache_pos`` None): fill the cache, full
            attention;
          * decode (``cache_pos`` given, S == 1): write at ``pos`` (ring slot
            ``pos % window`` for local attention), mask by ``k_valid``;
          * cross decode (``cross=True``): the cached encoder KV, untouched.
        A prefill of more than 2048 tokens takes :func:`chunked_attention`.
        Returns ``(y, cache)``; the cache is updated in place."""
        cfg = self.cfg
        cdt = dtype_of(cfg.compute_dtype)
        B, S, _ = x.shape
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q = split_last(self.wq(x, cdt), H, hd)
        if cfg.use_rope and not cross:
            q = rope(q, positions, cfg.rope_theta)
        q = constrain(q, "bthd")
        k_valid = None
        decode = cache_pos is not None
        if cross and decode:
            k, v = cache["k"], cache["v"]
            k_valid = k.shape[1]
        else:
            kv_in = x if kv_source is None else kv_source
            k = split_last(self.wk(kv_in, cdt), KV, hd)
            v = split_last(self.wv(kv_in, cdt), KV, hd)
            if cfg.use_rope and not cross and kv_source is None:
                k = rope(k, positions, cfg.rope_theta)
            if cache is not None and not decode:
                prefill_cache_write(k, cache["k"], window)
                prefill_cache_write(v, cache["v"], window)
            elif decode:
                Sc = cache["k"].shape[1]
                k = decode_cache_write(k, cache["k"], cache_pos, window)
                v = decode_cache_write(v, cache["v"], cache_pos, window)
                k_valid = torch.clamp(cache_pos + 1, max=Sc)
        if decode:
            out = attend(sdpa, q, k, v, causal=False, window=0, k_valid=k_valid)
        else:
            attn = chunked_attention if S > 2048 else sdpa
            out = attend(attn, q, k, v, causal=causal and kv_source is None, window=window,
                         prefix_len=prefix_len)
        return constrain(self.wo(out.reshape(B, S, H * hd), cdt), "btd"), cache


# -- MLPs ---------------------------------------------------------------------

class MLP(nn.Module):
    """swiglu / geglu (``w_in``, ``w_gate``, ``w_out``) or gelu (``w_in``,
    ``w_out``)."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        self.cfg = cfg
        d, ff = cfg.d_model, cfg.d_ff
        self.w_in = Dense(d, ff, dtype, device, generator)
        if cfg.mlp in ("swiglu", "geglu"):
            self.w_gate = Dense(d, ff, dtype, device, generator)
        else:
            self.w_gate = None
        self.w_out = Dense(ff, d, dtype, device, generator, scale=ff ** -0.5)

    def forward(self, x):
        cdt = dtype_of(self.cfg.compute_dtype)
        h = self.w_in(x, cdt)
        if self.cfg.mlp == "swiglu":
            h = F.silu(self.w_gate(x, cdt)) * h
        elif self.cfg.mlp == "geglu":
            h = gelu(self.w_gate(x, cdt)) * h
        else:
            h = gelu(h)
        h = constrain(h, "btf")
        return constrain(self.w_out(h, cdt), "btd")


# -- embeddings ---------------------------------------------------------------

class Embed(nn.Module):
    """The token table ``embed`` (scale 1) and, untied, ``out_head`` (scale
    ``d ** -0.5``)."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        self.cfg = cfg
        shape = (cfg.vocab_size, cfg.d_model)
        self.embed = nn.Parameter(trunc_normal(shape, 1.0, dtype, device, generator))
        if not cfg.tie_embeddings:
            self.out_head = nn.Parameter(
                trunc_normal(shape, cfg.d_model ** -0.5, dtype, device, generator))
        else:
            self.register_parameter("out_head", None)

    def lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        # index_select, not F.embedding: on the card the embedding's backward
        # reads a segment count back to the host, index_select's (an
        # index_add_) does not
        return embedding(self.embed, tokens).to(dtype_of(self.cfg.compute_dtype))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        cdt = dtype_of(self.cfg.compute_dtype)
        table = self.embed if self.cfg.tie_embeddings else self.out_head
        return constrain(dense(x.to(cdt), table.to(cdt).T), "logits")


def zeros_aux(cfg, device) -> Dict[str, torch.Tensor]:
    """The MoE aux scalars at zero (empty for a dense model)."""
    if not cfg.moe:
        return {}
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")}


__all__ = [
    "Attention", "Dense", "Embed", "MLP", "Norm", "chunked_attention", "decode_cache_write",
    "dtype_of", "gelu", "mask_bias", "prefill_cache_write", "rope", "sdpa", "softplus",
    "trunc_normal", "zeros_aux",
]
