"""Losses, the counterpart of ``repro/train/losses.py``: next-token
cross-entropy (fp32 logsumexp), an optional label mask, and the MoE
auxiliary losses."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


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
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, labels[..., None])[..., 0]
    nll = lse - picked
    m = mask[:, 1:].float() if mask is not None else torch.ones_like(nll)
    denom = torch.clamp(m.sum(), min=1.0)
    loss = (nll * m).sum() / denom
    acc = ((torch.argmax(lg, dim=-1) == labels) * m).sum() / denom
    return loss, dict(xent=loss, accuracy=acc, tokens=denom)


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
