"""Mixture-of-Experts FFN, the counterpart of ``repro/models/moe.py``:
group-wise capacity routing (GShard) with scatter/gather dispatch, and its
expert-parallel path over the "model" mesh axis.

  * Capacity is per sequence (a batch row is a group):
    ``cap = int(capacity_factor * S * k / E) + 1``.
  * An assignment's rank in its expert's queue comes from a stable argsort
    of the row's expert ids; ``pos == cap`` and beyond are dropped, and the
    gates are renormalized over the top k before the drop.
  * The router is fp32 at init and in use.
  * Every kept ``(b, e, pos)`` is unique, so the dispatch adds each token
    once onto a zero buffer (exact), with one spill slot per expert that
    takes the dropped ones and is cut off.

``cfg.moe_impl`` picks the path, as in the reference: ``"gspmd"`` (the
dispatch above; under a policy DTensor propagates its layouts, and the
routing's sort, which has no DTensor strategy, runs replicated through
``sharding.policy.replicated``) or ``"ep_shard_map"``, taken under a
policy whose mesh has a "model" axis (:func:`moe_ep`): each model rank
routes every token of its batch shard the same way, dispatches only to its
own ``E_pad / ms`` experts, and one all-reduce over the model axis sums the
partial combine.  Nothing here reads a value back to the host.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..sharding.policy import constrain, current_policy, dense, placements, replicated
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
        pol = current_policy()
        if (self.cfg.moe_impl == "ep_shard_map" and pol is not None and pol.mesh is not None
                and "model" in pol.shape):
            return moe_ep(self, x, pol)
        return self._gspmd(x)

    def _gspmd(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        E = cfg.n_experts
        probs, logits, gates, e_flat, pos, keep = route(x, self.w_router, cfg)
        B, S, _ = x.shape
        buf = dispatch(x, e_flat, pos, keep, E, cap_of(cfg, S), cfg)
        buf = constrain(buf, "moe_becd")
        out_buf = constrain(experts_ffn(buf, self.experts_in, self.experts_gate,
                                        self.experts_out, cfg), "moe_becd")
        out = combine(out_buf, e_flat, pos, keep, gates, cfg)
        return constrain(out, "btd"), aux_terms(probs, logits, e_flat, keep, E)


def cap_of(cfg, S: int) -> int:
    return max(int(cfg.capacity_factor * S * cfg.top_k / cfg.n_experts) + 1, 1)


def route(x, w_router, cfg):
    """``(probs, logits, gates, e_flat, pos, keep)``: the router's softmax
    over the experts, the top k renormalized, each assignment's expert and
    its position in that expert's queue, and whether it fits the
    capacity."""
    B, S, _ = x.shape
    k = cfg.top_k
    logits = dense(x.float(), w_router)  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)  # (B, S, k)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    e_flat = idx.reshape(B, S * k)
    pos = replicated("positions_in_expert", positions_in_expert, e_flat, cfg.n_experts)
    return probs, logits, gates, e_flat, pos, pos < cap_of(cfg, S)


def _dispatch(x, e_flat, pos, keep, E, cap, cdt, k):
    B, S, d = x.shape
    dev = x.device
    pos_c = torch.where(keep, pos, cap)  # cap: the spill slot
    tok_of = torch.arange(S, device=dev).repeat_interleave(k)  # (S * k,)
    gathered = x.to(cdt).index_select(1, tok_of)  # (B, S * k, d)
    rows = (torch.arange(B, device=dev)[:, None] * E + e_flat) * (cap + 1) + pos_c
    buf = torch.zeros((B * E * (cap + 1), d), dtype=cdt, device=dev)
    buf.index_add_(0, rows.reshape(-1),
                   torch.where(keep[..., None], gathered, 0).reshape(-1, d))
    return buf.reshape(B, E, cap + 1, d)[:, :, :cap]


def dispatch(x, e_flat, pos, keep, E, cap, cfg):
    """The (B, E, cap, d) expert buffers: each kept assignment's token at its
    expert and position (an assignment whose ``keep`` is False adds
    nothing)."""
    return replicated("moe_dispatch", _dispatch, x, e_flat, pos, keep, E, cap,
                      dtype_of(cfg.compute_dtype), cfg.top_k)


def experts_ffn(buf, w_in, w_gate, w_out, cfg):
    """The expert MLPs on their buffers: (B, E, cap, d) -> (B, E, cap, d)."""
    cdt = dtype_of(cfg.compute_dtype)
    h = torch.matmul(buf, w_in.to(cdt))  # (B, E, cap, ff)
    if w_gate is not None:
        act = F.silu if cfg.mlp == "swiglu" else gelu
        h = act(torch.matmul(buf, w_gate.to(cdt))) * h
    else:
        h = gelu(h)
    return torch.matmul(h, w_out.to(cdt))


def _combine(out_buf, e_flat, pos, keep, gates, k):
    B, E, cap, d = out_buf.shape
    S = e_flat.shape[1] // k
    dev = out_buf.device
    # a dropped assignment reads slot cap - 1, as the reference's clamped
    # gather does, and is zeroed by keep
    take = (torch.arange(B, device=dev)[:, None] * E + e_flat) * cap \
        + torch.clamp(pos, max=cap - 1)
    vals = out_buf.reshape(B * E * cap, d).index_select(0, take.reshape(-1))
    vals = vals.reshape(B, S * k, d) * (
        keep[..., None] * gates.reshape(B, S * k)[..., None]).to(out_buf.dtype)
    return vals.reshape(B, S, k, d).sum(dim=2)


def combine(out_buf, e_flat, pos, keep, gates, cfg):
    """Each assignment's expert output weighted by its gate, summed over the
    top k: (B, S, d)."""
    return replicated("moe_combine", _combine, out_buf, e_flat, pos, keep, gates, cfg.top_k)


def aux_terms(probs, logits, e_flat, keep, E) -> Dict[str, torch.Tensor]:
    """Load balance (GShard), router z-loss and drop fraction."""
    n = e_flat.numel()
    me = probs.mean(dim=(0, 1))  # (E,)
    ce = replicated("moe_expert_counts", lambda e: torch.zeros(
        E, dtype=torch.float32, device=e.device).index_add_(
            0, e.reshape(-1), torch.ones(n, dtype=torch.float32, device=e.device)), e_flat) / n
    return dict(
        moe_lb_loss=E * torch.sum(me * ce),
        moe_z_loss=torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        moe_drop_frac=1.0 - keep.float().mean(),
    )


# ---------------------------------------------------------------------------
# Expert parallelism over the "model" axis
# ---------------------------------------------------------------------------

AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")


def _to_local(t: DTensor, mesh, place, grad_place) -> torch.Tensor:
    """The local tensor of ``t`` laid out as ``place``; its gradient comes
    back laid out as ``grad_place`` (``Partial`` on a mesh dim whose ranks
    each give part of it)."""
    return t.redistribute(mesh, place).to_local(grad_placements=grad_place)


def moe_ep(moe: MoE, x, pol) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``_moe_apply_ep``: explicit local shards and one
    autograd-aware all-reduce.

    Every DTensor input is taken to its local tensor: the tokens sharded on
    the batch axes and whole on "model"; the router whole; the expert
    weights zero-padded from ``E`` to ``E_pad``, a multiple of the model
    axis (padded experts get no assignment: the router has ``E`` outputs),
    each model rank holding its ``E_l = E_pad / ms`` experts.  Each rank then
    routes all its tokens, dispatches only the assignments its experts own,
    and combines them into a partial sum.  The local results come back as
    DTensors that are ``Partial`` on "model" (the expert partial sums) and
    on the batch axes (the aux scalars, each scaled by ``1 / (ms * data)``,
    so their sum is the mean over the batch axes); redistributing them to
    ``Replicate`` is the all-reduce.  Every local input's gradient is
    declared ``Partial`` on "model" and on the batch axes, the transpose of
    that all-reduce, so autograd sums each rank's share."""
    cfg, mesh = moe.cfg, pol.mesh
    names = list(pol.shape)
    ms = pol.model_size
    E, k = cfg.n_experts, cfg.top_k
    E_pad = -(-E // ms) * ms
    E_l = E_pad // ms
    B, S, d = x.shape
    cap = cap_of(cfg, S)
    cdt = dtype_of(cfg.compute_dtype)
    rank = mesh.get_local_rank("model")
    bspec = tuple(pol.batch_axes) if pol.batch_axes and B % pol.data_size == 0 else None
    baxes = [a for a in ("pod", "data") if a in pol.shape]
    summed = [Partial() if a == "model" or a in baxes else Replicate() for a in names]
    x_place = placements(pol, (bspec, None, None))
    x_grad = [Partial() if a == "model" else p for a, p in zip(names, x_place)]
    rep = [Replicate()] * len(names)

    def local(t, place, grad):
        if not isinstance(t, DTensor):  # a plain tensor mixes in as a replicated one
            t = DTensor.from_local(t, mesh, rep, run_check=False)
        return _to_local(t, mesh, place, grad)

    x_l = local(x, x_place, x_grad)
    w_router = local(moe.w_router, rep, summed)

    def experts(w):
        if w is None:
            return None
        if E_pad == E:  # each model rank's slab of the expert dim
            place = [Shard(0) if a == "model" else Replicate() for a in names]
            grad = [Shard(0) if a == "model" else s for a, s in zip(names, summed)]
            return local(w, place, grad)
        w = F.pad(local(w, rep, summed), (0, 0) * (w.dim() - 1) + (0, E_pad - E))
        return w[rank * E_l:(rank + 1) * E_l]

    w_in, w_gate, w_out = (experts(w) for w in (moe.experts_in, moe.experts_gate,
                                                  moe.experts_out))
    probs, logits, gates, e_flat, pos, keep = route(x_l, w_router, cfg)
    # ownership: only the assignments routed to this rank's experts
    e_local = e_flat - rank * E_l
    mine = (e_local >= 0) & (e_local < E_l) & keep
    e_idx = torch.where(mine, e_local, 0)
    buf = _dispatch(x_l, e_idx, pos, mine, E_l, cap, cdt, k)
    out_buf = experts_ffn(buf, w_in, w_gate, w_out, cfg)
    partial = _combine(out_buf, e_idx, pos, mine, gates, k)
    aux = aux_terms(probs, logits, e_flat, keep, E)
    out_place = [Partial() if a == "model" else p for a, p in zip(names, x_place)]
    out = DTensor.from_local(partial, mesh, out_place, run_check=False)
    out = out.redistribute(mesh, x_place)
    n_avg = ms * math.prod(pol.shape[a] for a in baxes)
    vec = torch.stack([aux[key] for key in AUX_KEYS]) / n_avg
    vec = DTensor.from_local(vec, mesh, summed, run_check=False).redistribute(mesh, rep)
    return constrain(out, "btd"), {key: vec[i] for i, key in enumerate(AUX_KEYS)}

