"""Mixture-of-Experts FFN, the counterpart of ``repro/models/moe.py``'s
``gspmd`` path (``_moe_apply_gspmd``): group-wise capacity routing (GShard)
with scatter/gather dispatch.

  * Capacity is per sequence (a batch row is a group):
    ``cap = int(capacity_factor * S * k / E) + 1``.
  * An assignment's rank in its expert's queue comes from a stable argsort
    of the row's expert ids; ``pos == cap`` and beyond are dropped, and the
    gates are renormalized over the top k before the drop.
  * The router is fp32 at init and in use.
  * Every kept ``(b, e, pos)`` is unique, so the dispatch adds each token
    once onto a zero buffer (exact), with one spill slot per expert that
    takes the dropped ones and is cut off.

The ``ep_shard_map`` path needs a device mesh and comes with sharding.
Nothing here reads a value back to the host.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import dtype_of, gelu, trunc_normal


def positions_in_expert(e_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Per row (the last axis): the position of each assignment within its
    expert's queue, in a stable order.  e_idx: (..., A) expert ids."""
    A = e_idx.shape[-1]
    order = torch.argsort(e_idx, dim=-1, stable=True)
    sorted_e = torch.gather(e_idx, -1, order)
    counts = torch.zeros(e_idx.shape[:-1] + (n_experts,), dtype=torch.int64,
                         device=e_idx.device).scatter_add_(-1, e_idx, torch.ones_like(e_idx))
    starts = torch.cumsum(counts, dim=-1) - counts
    ranks_sorted = torch.arange(A, device=e_idx.device) - torch.gather(starts, -1, sorted_e)
    return torch.empty_like(e_idx).scatter_(-1, order, ranks_sorted)


class MoE(nn.Module):
    """``w_router`` (fp32), ``experts_in``, ``experts_gate`` (gated MLPs)
    and ``experts_out``."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        self.cfg = cfg
        E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
        init = lambda shape, scale, dt: nn.Parameter(
            trunc_normal(shape, scale, dt, device, generator))
        self.w_router = init((d, E), d ** -0.5, torch.float32)
        self.experts_in = init((E, d, ff), d ** -0.5, dtype)
        if cfg.mlp in ("swiglu", "geglu"):
            self.experts_gate = init((E, d, ff), d ** -0.5, dtype)
        else:
            self.register_parameter("experts_gate", None)
        self.experts_out = init((E, ff, d), ff ** -0.5, dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """x: (B, S, d) -> (out (B, S, d), aux)."""
        cfg = self.cfg
        cdt = dtype_of(cfg.compute_dtype)
        B, S, d = x.shape
        E, k = cfg.n_experts, cfg.top_k
        cap = max(int(cfg.capacity_factor * S * k / E) + 1, 1)
        dev = x.device

        logits = x.float() @ self.w_router  # (B, S, E)
        probs = torch.softmax(logits, dim=-1)
        gates, idx = torch.topk(probs, k, dim=-1)  # (B, S, k)
        gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)

        e_flat = idx.reshape(B, S * k)
        pos = positions_in_expert(e_flat, E)
        keep = pos < cap
        pos_c = torch.where(keep, pos, cap)  # cap: the spill slot

        # dispatch into (B, E, cap + 1, d); the spill slot is cut off
        xt = x.to(cdt)
        tok_of = torch.arange(S, device=dev).repeat_interleave(k)  # (S * k,)
        gathered = xt.index_select(1, tok_of)  # (B, S * k, d)
        rows = (torch.arange(B, device=dev)[:, None] * E + e_flat) * (cap + 1) + pos_c
        buf = torch.zeros((B * E * (cap + 1), d), dtype=cdt, device=dev)
        buf.index_add_(0, rows.reshape(-1),
                       torch.where(keep[..., None], gathered, 0).reshape(-1, d))
        buf = buf.reshape(B, E, cap + 1, d)[:, :, :cap]

        # expert FFN: contract d per expert
        h = torch.matmul(buf, self.experts_in.to(cdt))  # (B, E, cap, ff)
        if self.experts_gate is not None:
            g = torch.matmul(buf, self.experts_gate.to(cdt))
            act = F.silu if cfg.mlp == "swiglu" else gelu
            h = act(g) * h
        else:
            h = gelu(h)
        out_buf = torch.matmul(h, self.experts_out.to(cdt))  # (B, E, cap, d)

        # combine: gather back per assignment (a dropped one reads slot
        # cap - 1, as the reference's clamped gather does, and is zeroed by
        # keep), weight by its gate, sum over k
        take = (torch.arange(B, device=dev)[:, None] * E + e_flat) * cap \
            + torch.clamp(pos_c, max=cap - 1)
        vals = out_buf.reshape(B * E * cap, d).index_select(0, take.reshape(-1))
        vals = vals.reshape(B, S * k, d) * (
            keep[..., None] * gates.reshape(B, S * k)[..., None]).to(cdt)
        out = vals.reshape(B, S, k, d).sum(dim=2)

        # aux: load balance (GShard), router z-loss, drop fraction
        me = probs.mean(dim=(0, 1))  # (E,)
        ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
            0, e_flat.reshape(-1), torch.ones(B * S * k, dtype=torch.float32, device=dev)
        ) / (B * S * k)
        aux = dict(
            moe_lb_loss=E * torch.sum(me * ce),
            moe_z_loss=torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
            moe_drop_frac=1.0 - keep.float().mean(),
        )
        return out, aux
