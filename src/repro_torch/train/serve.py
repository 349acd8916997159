"""Serving: prefill, KV-cache decode steps (batched) and the greedy or
sampled generation loop; the counterpart of ``repro/train/serve.py``.

The port's models are ``nn.Module``s that own their parameters, so the
functions here take no ``params``: ``prefill(tokens, extras)`` and
``serve_step(cache, token, pos)``.  A decode step reads its position from
a 0-d device tensor and writes the cache in place, so it never waits on
the host; the generation loop keeps its position on the device.

With a ``policy`` (the model's parameters DTensors from
``sharding.policy.shard_model``) both run under ``policy_context``: the
tokens and extras are sharded over the batch axes, the prefill's cache is
laid out by ``launch.specs.cache_spec`` (batch over the batch axes, a KV
cache's sequence over "model"), and the logits come back whole as plain
tensors.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..sharding.policy import Policy, distribute, policy_context
from .train_loop import plain, shard_batch


def shard_cache(policy: Optional[Policy], cache, batch: int):
    """The cache's tensors as DTensors laid out by
    ``launch.specs.cache_spec`` (unchanged without a policy)."""
    if policy is None or policy.mesh is None:
        return cache
    from ..launch.specs import cache_spec

    def one(x):
        return distribute(policy, x, cache_spec(policy, tuple(x.shape), batch))
    if isinstance(cache, dict):
        return {k: one(v) for k, v in cache.items()}
    return [{k: one(v) for k, v in layer.items()} for layer in cache]


def make_prefill_fn(model, cfg, policy: Optional[Policy] = None,
                    cache_len: Optional[int] = None):
    def prefill(tokens: torch.Tensor, extras: Optional[Dict] = None):
        """tokens: (B, S_prompt).  Returns ``(cache, last_logits)``."""
        B, S = tokens.shape
        with torch.no_grad(), policy_context(policy):
            kwargs = shard_batch(policy, dict(extras or {}))
            if cfg.encdec:
                cache = model.init_cache(B, cache_len or cfg.max_seq,
                                         kwargs["frames"].shape[1])
            else:
                cache = model.init_cache(B, cache_len or S)
            cache = shard_cache(policy, cache, B)
            tokens = shard_batch(policy, {"t": tokens})["t"]
            logits, cache, _ = model(tokens, cache=cache, **kwargs)
            return cache, plain(logits[:, -1])

    return prefill


def make_serve_step(model, cfg, policy: Optional[Policy] = None):
    """Decode one token: ``(cache, token (B, 1), pos) -> (logits (B, V),
    cache)``, ``pos`` a 0-d device tensor."""

    def serve_step(cache, token: torch.Tensor, pos: torch.Tensor):
        with torch.no_grad(), policy_context(policy):
            token = shard_batch(policy, {"t": token})["t"]
            logits, cache, _ = model(token, cache=cache, cache_pos=pos)
            return plain(logits[:, -1]), cache

    return serve_step


def greedy_generate(
    model, cfg, prompt: torch.Tensor, max_new: int, extras: Optional[Dict] = None,
    temperature: float = 0.0, seed: int = 0, cache_len: Optional[int] = None,
) -> torch.Tensor:
    """Batched generation: ``(B, max_new)`` int32 tokens.  Greedy at
    ``temperature == 0``; above it each token is drawn from the softmax of
    ``logits / temperature`` with a ``torch.Generator`` on the prompt's
    device, seeded with ``seed``.

    As the reference does, the decode steps take positions ``S``, ``S + 1``,
    ... with ``S`` the prompt's length: for a VLM, whose prefill also
    cached its image tokens, that writes over cached slots (ROADMAP F10,
    kept for parity)."""
    B, S = prompt.shape
    total = cache_len or (S + max_new)
    prefill = make_prefill_fn(model, cfg, cache_len=total)
    step = make_serve_step(model, cfg)
    cache, logits = prefill(prompt, extras)
    generator = None
    if temperature and temperature > 0:
        generator = torch.Generator(device=prompt.device).manual_seed(seed)
    pos = torch.full((), S, dtype=torch.int32, device=prompt.device)
    toks = []
    cur = _pick(logits, temperature, generator)
    for _ in range(max_new):
        toks.append(cur)
        logits, cache = step(cache, cur[:, None], pos)
        pos = pos + 1
        cur = _pick(logits, temperature, generator)
    return torch.stack(toks, dim=1)


def _pick(logits: torch.Tensor, temperature: float, generator) -> torch.Tensor:
    if temperature and temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)
