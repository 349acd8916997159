"""The train step and the training driver, the counterpart of
``repro/train/train_loop.py``: loss -> gradients -> clip -> optimizer,
with gradient accumulation and remat (per group, in the model).

The port's models own their parameters, so the step takes no params: it
is ``train_step(opt_state, batch) -> (opt_state, metrics)`` and updates
the model in place.  Its metrics are 0-d device tensors; nothing in a step
reads a value back to the host.

With a ``policy`` (``sharding.policy``; the model's parameters DTensors
from ``shard_model``) the step runs under ``policy_context``: each rank
passes the same global batch, every input is sharded over the policy's
batch axes (each rank keeps its chunk, no collective), and the metrics
come back as plain replicated 0-d tensors.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from .. import convert
from ..models.leaves import lm_param_leaves
from ..sharding.policy import Policy, distribute, policy_context
from .losses import total_loss
from .optimizer import flat_params, like_params


def make_loss_fn(model, cfg):
    """``loss_fn(batch) -> (loss, metrics)``: the batch holds ``tokens``,
    ``frames`` for an enc-dec, ``img_embed`` for a VLM (whose logits cover
    the image prefix and the text; only the text is scored)."""
    def loss_fn(batch):
        kwargs = {}
        if cfg.encdec:
            kwargs["frames"] = batch["frames"]
        if cfg.n_img_tokens:
            kwargs["img_embed"] = batch["img_embed"]
        logits, _, aux = model(batch["tokens"], **kwargs)
        if cfg.n_img_tokens:
            logits = logits[:, cfg.n_img_tokens:]
        return total_loss(logits, batch["tokens"], aux)

    return loss_fn


def shard_batch(policy: Optional[Policy], batch: Dict[str, torch.Tensor]):
    """The batch's tensors sharded on their leading dim over the policy's
    batch axes (the reference's ``input_shardings``); unchanged without a
    policy or where a tensor is a DTensor already."""
    if policy is None or policy.mesh is None:
        return batch
    b = tuple(policy.batch_axes) or None
    return {k: v if isinstance(v, DTensor) or v.dim() == 0
            else distribute(policy, v, (b,) + (None,) * (v.dim() - 1))
            for k, v in batch.items()}


def plain(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value as a plain tensor (a replicated one is its
    local tensor), else ``t``."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_train_step(model, cfg, optimizer, policy: Optional[Policy] = None,
                    grad_accum: int = 1) -> Callable:
    """``train_step(opt_state, batch) -> (opt_state, metrics)``.  With
    ``grad_accum > 1`` the batch's leading axis splits into that many
    microbatches; their gradients are summed into fp32 buffers and divided
    by ``grad_accum``, and the metrics are the last microbatch's (the
    reference's ``lax.scan``).  With a ``policy`` the step runs under it
    (see the module's docstring)."""
    loss_fn = make_loss_fn(model, cfg)

    def grads_of(params, batch):
        loss, metrics = loss_fn(shard_batch(policy, batch))
        grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        return grads, {k: plain(v.detach()) for k, v in metrics.items()}

    def train_step(opt_state, batch):
        with policy_context(policy):
            params = flat_params(opt_state)
            if grad_accum > 1:
                acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
                b = next(iter(batch.values())).shape[0] // grad_accum
                for i in range(grad_accum):
                    micro = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                    grads, metrics = grads_of(params, micro)
                    torch._foreach_add_(acc, [g.float() for g in like_params(grads, params)])
                    del grads
                grads = torch._foreach_div(acc, float(grad_accum))
                del acc
            else:
                grads, metrics = grads_of(params, batch)
            opt_state, opt_metrics = optimizer.update(grads, opt_state)
        return opt_state, dict(metrics, **{k: plain(v) for k, v in opt_metrics.items()})

    return train_step


def fit(
    model,
    cfg,
    optimizer,
    data_iter,
    *,
    steps: int,
    params: Optional[Dict[str, torch.Tensor]] = None,
    opt_state=None,
    ckpt_manager=None,
    ckpt_every: int = 0,
    start_step: int = 0,
    log_every: int = 10,
    log_fn=print,
    grad_accum: int = 1,
) -> Tuple[Dict[str, torch.Tensor], Any, Dict]:
    """Single-process training driver with checkpoint and restart.
    ``params``, a ``state_dict``, is loaded into the model first (the
    model's own parameters when None); ``data_iter`` yields ``(step,
    batch)`` with the batch on the host, moved here to the model's device.
    A checkpoint holds the reference launcher's tree
    (``convert.lm_train_tree``).  Metrics are read on the host only on a
    log step.  ``start_step`` is the reference's argument, unused there
    too: the iterator's steps count.  Returns ``(model.state_dict(),
    opt_state, last_metrics)``."""
    if params is not None:
        model.load_state_dict(params)
    if opt_state is None:
        opt_state = optimizer.init(lm_param_leaves(cfg, model))
    step_fn = make_train_step(model, cfg, optimizer, grad_accum=grad_accum)
    dev = next(model.parameters()).device
    metrics: Dict = {}
    for step, batch in data_iter:
        if step >= steps:
            break
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        opt_state, metrics = step_fn(opt_state, batch)
        if log_every and (step % log_every == 0 or step == steps - 1):
            m = {k: float(v) for k, v in metrics.items()}
            log_fn(f"step {step:5d} loss {m.get('loss', 0):.4f} "
                   f"acc {m.get('accuracy', 0):.3f} gnorm {m.get('grad_norm', 0):.2f}")
        if ckpt_manager is not None and ckpt_every and (step + 1) % ckpt_every == 0:
            ckpt_manager.save(step + 1, convert.lm_train_tree(cfg, model, opt_state))
    if ckpt_manager is not None:
        ckpt_manager.wait()
    return model.state_dict(), opt_state, metrics
