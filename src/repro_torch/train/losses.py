"""Losses, the counterpart of ``repro/train/losses.py``: next-token
cross-entropy (fp32 logsumexp), an optional label mask, and the MoE
auxiliary losses.  Logits sharded over the vocab (a DTensor under a
sharding policy) take forms whose reductions stay sharded."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor


def next_token_xent(
    logits: torch.Tensor,  # (B, S, V)
    tokens: torch.Tensor,  # (B, S) int (the same sequence; labels = shift)
    mask: Optional[torch.Tensor] = None,  # (B, S) over *label* positions
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``loss = mean CE(logits[:, :-1], tokens[:, 1:])`` over the unmasked
    labels; the metrics hold ``xent``, ``accuracy`` and ``tokens`` (the
    count of labels), all 0-d tensors on the logits' device."""
    lg = logits[:, :-1].float()
    labels = tokens[:, 1:].long()
    if isinstance(lg, DTensor):
        lse, picked, pred = _vocab_sharded(lg, labels)
    else:
        lse = torch.logsumexp(lg, dim=-1)
        picked = torch.gather(lg, -1, labels.unsqueeze(-1)).squeeze(-1)
        pred = torch.argmax(lg, dim=-1)
    nll = lse - picked
    m = mask[:, 1:].float() if mask is not None else torch.ones_like(nll)
    denom = torch.clamp(m.sum(), min=1.0)
    loss = (nll * m).sum() / denom
    acc = ((pred == labels) * m).sum() / denom
    return loss, dict(xent=loss, accuracy=acc, tokens=denom)


def _vocab_sharded(lg, labels):
    """``(logsumexp, the label's logit, argmax)`` over the vocab axis in
    forms whose reductions DTensor keeps sharded (a max, a sum and a min,
    each an all-reduce of (B, S) values) where ``logsumexp``, ``gather``
    and ``argmax`` would gather the whole (B, S, V) logits first: the
    logsumexp from the max (a constant shift, detached: its gradient is the
    softmax), the logit as a masked sum (exact: one term and zeros), the
    argmax as the first index holding the max."""
    V = lg.shape[-1]
    vocab = torch.arange(V, device=lg.device)
    top = lg.amax(dim=-1, keepdim=True).detach()  # a constant shift: no gradient
    lse = (top + torch.log(torch.exp(lg - top).sum(dim=-1, keepdim=True))).squeeze(-1)
    picked = torch.where(labels.unsqueeze(-1) == vocab, lg, 0.0).sum(dim=-1)
    pred = torch.where(lg == top, vocab, V).amin(dim=-1)
    return lse, picked, pred


def total_loss(logits, tokens, aux: Dict, *, mask=None, moe_lb_weight: float = 0.01,
               moe_z_weight: float = 1e-3) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The cross-entropy plus ``moe_lb_weight * moe_lb_loss + moe_z_weight *
    moe_z_loss`` where ``aux`` has them (an MoE); the aux joins the
    metrics, and ``loss`` is the total."""
    loss, metrics = next_token_xent(logits, tokens, mask)
    if "moe_lb_loss" in aux:
        loss = loss + moe_lb_weight * aux["moe_lb_loss"] + moe_z_weight * aux["moe_z_loss"]
        metrics.update({k: aux[k] for k in aux})
    metrics["loss"] = loss
    return loss, metrics
