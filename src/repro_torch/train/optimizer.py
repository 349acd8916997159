"""Optimizers, the counterpart of ``repro/train/optimizer.py``: AdamW with
optional 8-bit block-quantized moments, SGD-momentum, global-norm clipping
and the cosine schedule.

The state keeps the reference's leaf layout.  The reference optimizes a
params tree whose decoder layers are stacked (``groups``: one leaf of
shape ``(L // P, ...)`` per position of the block pattern); the port's
model holds one module per layer.  So the state holds one entry per
reference leaf, in the reference's flatten order
(``models.leaves.lm_param_leaves``): the moments in the stacked shape (or the
8-bit ``{"q", "scale"}`` of that shape), beside the port parameters the
leaf stacks.  Two rules of the reference depend on that stacked shape, and
the port applies them to it, never to a parameter's own ``ndim``:

  * weight decay goes to a leaf whose stacked shape has ``ndim >= 2``, so a
    stacked ``(L // P, d)`` norm scale is decayed, ``ln_f``'s ``(d,)`` and a
    ``rest`` layer's 1-D leaves are not;
  * the 8-bit blocks (``BLOCK`` slots, one fp32 absmax scale each) run per
    slice of the leading axis only when the stacked shape has ``ndim >= 3``
    and a leading size over 1 (``_lead``); otherwise over the whole
    flattened leaf, so a stacked norm's blocks straddle its layers.

The update runs in place under ``torch.no_grad()``, on views of the
parameters and of the moments, one slice of the leading axis at a time for
the 8-bit moments (its fp32 temporaries exist one slice at a time).
``count`` and ``lr`` are 0-d device tensors and nothing in ``update`` reads
a value back to the host.

On DTensor parameters (``sharding.policy.shard_model``) the moments take
their parameters' placements, a stacked leaf's one dim further in (the
reference's ``opt_shardings``: ``m`` and ``v`` as the params), and the
8-bit blocks shard their leading dim as widely as it divides
(``sharding.policy.q8_spec``).  ``update`` first lays each gradient out as
its parameter (an all-reduce or reduce-scatter of the data-parallel
partial sums), sums the norm's squares over the shards that hold distinct
values, and then runs the same elementwise update on the local shards.
The 8-bit update dequantizes a leaf's blocks, which cut across its
parameters' shards, so it gathers that leaf's parameters, gradients and
blocks whole, runs the update replicated and keeps each rank's chunk
(GSPMD's answer to the same reshape).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..models.leaves import ParamLeaf
from ..sharding.policy import local_shape, mesh_shape, placements, q8_spec

BLOCK = 128
_INV127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))


def flat_params(state) -> List[torch.Tensor]:
    """The port parameters of ``state``'s leaves, in order: the order of
    the gradients ``update`` takes."""
    return [p for leaf in state["leaves"] for p in leaf.params]


# ---------------------------------------------------------------------------
# 8-bit blockwise quantization
# ---------------------------------------------------------------------------

def _lead(shape: Tuple[int, ...]) -> int:
    """The leading 'stack' size kept through quantization: the slices the
    update streams one at a time."""
    return shape[0] if len(shape) >= 3 and shape[0] > 1 else 1


def _q8_rows(flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)`` of one slice's flat fp32 values: zero-padded to whole
    ``BLOCK``s, ``scale = absmax / 127`` a block, ``q = round(x / max(scale,
    1e-12))`` in int8 (round half to even, as ``jnp.round``)."""
    pad = (-flat.shape[0]) % BLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    # times fp32(1 / 127): XLA compiles the reference's ``absmax / 127.0``
    # to that product (its update and train step always run compiled)
    scale = blocks.abs().amax(dim=1, keepdim=True) * _INV127
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale


def _q8_quantize(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The reference's ``_q8_quantize`` of a leaf ``x`` in its stacked
    shape: ``q`` int8 ``(L, NB, BLOCK)`` and ``scale`` fp32 ``(L, NB, 1)``
    with ``L = _lead(x.shape)``."""
    L = _lead(tuple(x.shape))
    rows = [_q8_rows(r) for r in x.float().reshape(L, -1)]
    return dict(q=torch.stack([q for q, _ in rows]), scale=torch.stack([s for _, s in rows]))


def _q8_dequantize(s: Dict[str, torch.Tensor], shape: Tuple[int, ...]) -> torch.Tensor:
    L = _lead(shape)
    flat = (s["q"].float() * s["scale"]).reshape(L, -1)
    return flat[:, : math.prod(shape) // L].reshape(shape)


def _q8_zeros(shape: Tuple[int, ...], device) -> Dict[str, torch.Tensor]:
    L = _lead(shape)
    nb = -(-(math.prod(shape) // L) // BLOCK)
    return dict(q=torch.zeros((L, nb, BLOCK), dtype=torch.int8, device=device),
                scale=torch.zeros((L, nb, 1), dtype=torch.float32, device=device))


def _rows(leaf: ParamLeaf, values: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """The leaf's quantization slices as lists of flat views of ``values``
    (one tensor per parameter of the leaf, the parameter's shape): slice
    ``g`` of a stacked leaf is parameter ``g``, slice ``i`` of an unstacked
    leaf row ``i`` of its parameter, and a leaf with ``_lead == 1`` one
    slice of all its parameters in order."""
    L = _lead(leaf.shape)
    if L == 1:
        return [[v.reshape(-1) for v in values]]
    if leaf.stacked:
        return [[v.reshape(-1)] for v in values]
    return [[row.reshape(-1)] for row in values[0]]


# ---------------------------------------------------------------------------
# DTensor parameters
# ---------------------------------------------------------------------------

def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (its storage, under ``no_grad``), else ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def like_params(grads, params) -> List[torch.Tensor]:
    """Each gradient in its parameter's layout (a data-parallel ``Partial``
    gradient is all-reduced or reduce-scattered here)."""
    return [g.redistribute(p.device_mesh, p.placements)
            if isinstance(g, DTensor) and g.placements != p.placements else g
            for g, p in zip(grads, params)]


def _as_dtensor(local: torch.Tensor, mesh, place, shape) -> DTensor:
    return DTensor.from_local(local, mesh, place, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _chunk(full: torch.Tensor, like: DTensor) -> torch.Tensor:
    """This rank's chunk of ``full`` in ``like``'s layout (no collective)."""
    rep = DTensor.from_local(full, like.device_mesh, [Replicate()] * like.device_mesh.ndim,
                             run_check=False)
    return rep.redistribute(like.device_mesh, like.placements).to_local()


def moment_zeros(leaf: ParamLeaf) -> torch.Tensor:
    """fp32 zeros in the leaf's (stacked) shape; on DTensor parameters a
    DTensor in their layout, a stacked leaf's shard dims one further in."""
    p = leaf.params[0]
    if not isinstance(p, DTensor):
        return torch.zeros(leaf.shape, dtype=torch.float32, device=p.device)
    local = p.to_local()
    lead = (len(leaf.params),) if leaf.stacked else ()
    place = [Shard(s.dim + len(lead)) if isinstance(s, Shard) else s for s in p.placements]
    z = torch.zeros(lead + tuple(local.shape), dtype=torch.float32, device=local.device)
    return _as_dtensor(z, p.device_mesh, place, leaf.shape)


def _q8_sharded(leaf: ParamLeaf, z: torch.Tensor) -> torch.Tensor:
    """An 8-bit block tensor of zeros for ``leaf``, on DTensor parameters a
    DTensor laid out by ``q8_spec``."""
    p = leaf.params[0]
    if not isinstance(p, DTensor):
        return z
    mesh = p.device_mesh
    axes = mesh_shape(mesh)
    spec = q8_spec(axes, tuple(z.shape))
    return _as_dtensor(z.new_zeros(local_shape(axes, spec, tuple(z.shape))), mesh,
                       placements(axes, spec), tuple(z.shape))


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1) -> Callable:
    """``lr(step)`` for a 0-d step tensor (or an int): linear warm-up to
    ``peak_lr``, then a cosine down to ``floor * peak_lr`` at ``total``; a
    0-d fp32 tensor, computed as the reference's ``cosine_schedule`` does."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sqrt`` of the sum of every element's square, as an fp32 0-d
    tensor.  The sums run in fp64, so the result is the correctly rounded
    norm on any device, whatever order a device's reduction takes (an fp32
    sum over a 28 M-element embedding differed by 6e-6 between the card and
    the CPU)."""
    tensors = list(tensors)
    if not any(isinstance(t, DTensor) for t in tensors):
        norms = torch._foreach_norm(tensors, 2, dtype=torch.float64)
        return torch.sqrt(torch.sum(torch.stack(norms) ** 2)).float()
    # DTensors: each shard's squares, summed over the mesh dims that shard
    # the tensor (a replicated dim holds the same values on every rank)
    groups: Dict[Tuple, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(tuple(t.placements), []).append(t.to_local())
    mesh = next(t.device_mesh for t in tensors if isinstance(t, DTensor))
    total = 0.0
    for place, local in groups.items():
        sq = torch.stack(torch._foreach_norm(local, 2, dtype=torch.float64)) ** 2
        summed = [Partial() if isinstance(p, Shard) else Replicate() for p in place]
        total = total + DTensor.from_local(sq, mesh, summed, run_check=False).full_tensor().sum()
    return torch.sqrt(total).float()


def _clip_scale(gnorm: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """``min(1, clip_norm / (gnorm + 1e-9))`` (a true division: torch's
    ``float / tensor`` multiplies by a reciprocal)."""
    return torch.clamp(torch.full_like(gnorm, clip_norm) / (gnorm + 1e-9), max=1.0)


def _lr_of(lr, count: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(count)
    return torch.full((), lr, dtype=torch.float32, device=count.device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Any = 3e-4  # float or schedule(step) -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    quantize_moments: bool = False

    def init(self, leaves: Sequence[ParamLeaf]) -> Dict[str, Any]:
        """``dict(leaves, m, v, count)``: one moment entry per leaf (an
        LM's ``lm_param_leaves(cfg, model)``), zeros in the leaf's stacked
        shape (fp32) or its 8-bit ``{"q", "scale"}``, on the leaf's
        device."""
        leaves = list(leaves)
        dev = leaves[0].params[0].device

        def zeros(leaf):
            if self.quantize_moments:
                return {k: _q8_sharded(leaf, z) for k, z in _q8_zeros(leaf.shape, dev).items()}
            return moment_zeros(leaf)

        return dict(leaves=leaves, m=[zeros(leaf) for leaf in leaves],
                    v=[zeros(leaf) for leaf in leaves],
                    count=torch.zeros((), dtype=torch.int32, device=dev))

    def _core(self, P, G, M, V, decay: bool, c1, c2, lr, clip) -> None:
        """The reference's ``_core`` on lists of views, in place: ``M``,
        ``V`` fp32, ``P`` the parameters (or their pieces), ``G`` the fp32
        gradients, times ``clip`` (a 0-d tensor) unless it is None; the same
        operations in the same order.  Its temporaries are the size of the
        lists given (one leaf, or one slice of an 8-bit leaf)."""
        b1, b2 = self.b1, self.b2
        if clip is not None:
            G = torch._foreach_mul(G, clip)
        torch._foreach_mul_(M, b1)
        torch._foreach_add_(M, torch._foreach_mul(G, 1 - b1))
        gg = torch._foreach_mul(G, 1 - b2)
        torch._foreach_mul_(gg, G)
        torch._foreach_mul_(V, b2)
        torch._foreach_add_(V, gg)
        del gg
        upd = torch._foreach_div(M, c1)
        den = torch._foreach_div(V, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        del den
        pf = [p.float() for p in P]
        if self.weight_decay and decay:
            torch._foreach_add_(upd, torch._foreach_mul(pf, self.weight_decay))
        torch._foreach_mul_(upd, lr)
        if all(p.dtype == torch.float32 for p in P):
            torch._foreach_sub_(P, upd)
        else:
            torch._foreach_copy_(P, torch._foreach_sub(pf, upd))

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state) -> Tuple[Dict, Dict]:
        """One step in place, on the parameters and on ``state`` (its
        moments and its ``count``): ``grads`` in the order of
        :func:`flat_params`.  Returns ``(state, metrics)`` with
        ``grad_norm`` and ``lr``, 0-d device tensors."""
        grads = [g.float() for g in like_params(grads, flat_params(state))]
        count = state["count"] + 1
        gnorm = global_norm(grads)
        clip = _clip_scale(gnorm, self.clip_norm) if self.clip_norm is not None else None
        c1 = 1 - torch.pow(self.b1, count.float())
        c2 = 1 - torch.pow(self.b2, count.float())
        lr = _lr_of(self.lr, count)
        it = iter(grads)
        for leaf, m, v in zip(state["leaves"], state["m"], state["v"]):
            gs = [next(it) for _ in leaf.params]
            decay = len(leaf.shape) >= 2
            if not self.quantize_moments:
                M, V = _local(m), _local(v)
                M, V = (list(M), list(V)) if leaf.stacked else ([M], [V])
                self._core([_local(p) for p in leaf.params], [_local(g) for g in gs], M, V,
                           decay, c1, c2, lr, clip)
                continue
            if isinstance(m["q"], DTensor):
                ps, gs = [p.full_tensor() for p in leaf.params], [g.full_tensor() for g in gs]
                mf = {k: x.full_tensor() for k, x in m.items()}
                vf = {k: x.full_tensor() for k, x in v.items()}
                self._q8_leaf(leaf, ps, gs, mf, vf, decay, c1, c2, lr, clip)
                for dst, src in zip(leaf.params + list(m.values()) + list(v.values()),
                                    ps + list(mf.values()) + list(vf.values())):
                    dst.to_local().copy_(_chunk(src, dst))
                continue
            self._q8_leaf(leaf, leaf.params, gs, m, v, decay, c1, c2, lr, clip)
        state["count"] = count
        return state, dict(grad_norm=gnorm, lr=lr)

    def _q8_leaf(self, leaf, params, gs, m, v, decay, c1, c2, lr, clip) -> None:
        """One leaf's 8-bit update in place, a slice of its leading axis at a
        time, on plain tensors."""
        prow, grow = _rows(leaf, params), _rows(leaf, gs)
        for i in range(_lead(leaf.shape)):
            sizes = [x.numel() for x in prow[i]]
            m_f = (m["q"][i].float() * m["scale"][i]).reshape(-1)[:sum(sizes)]
            v_f = (v["q"][i].float() * v["scale"][i]).reshape(-1)[:sum(sizes)]
            self._core(prow[i], grow[i], list(m_f.split(sizes)), list(v_f.split(sizes)),
                       decay, c1, c2, lr, clip)
            for qs, x in ((m, m_f), (v, v_f)):
                q, scale = _q8_rows(x)
                qs["q"][i].copy_(q)
                qs["scale"][i].copy_(scale)


@dataclasses.dataclass(frozen=True)
class SGDM:
    lr: Any = 1e-2
    momentum: float = 0.9
    clip_norm: Optional[float] = 1.0

    def init(self, leaves: Sequence[ParamLeaf]) -> Dict[str, Any]:
        """``dict(leaves, mu, count)``, ``mu`` fp32 zeros per leaf."""
        leaves = list(leaves)
        dev = leaves[0].params[0].device
        return dict(leaves=leaves, mu=[moment_zeros(leaf) for leaf in leaves],
                    count=torch.zeros((), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state) -> Tuple[Dict, Dict]:
        """``mu = momentum * mu + g``, ``p = p - lr * mu``, in place (the
        parameters and ``state``), ``grads`` in the order of
        :func:`flat_params`."""
        params = flat_params(state)
        grads = [g.float() for g in like_params(grads, params)]
        count = state["count"] + 1
        gnorm = global_norm(grads)
        params, grads = [_local(p) for p in params], [_local(g) for g in grads]
        if self.clip_norm is not None:
            grads = torch._foreach_mul(grads, _clip_scale(gnorm, self.clip_norm))
        lr = _lr_of(self.lr, count)
        mus = [x for leaf, mu in zip(state["leaves"], state["mu"])
               for x in (list(_local(mu)) if leaf.stacked else [_local(mu)])]
        torch._foreach_mul_(mus, self.momentum)
        torch._foreach_add_(mus, grads)
        step = torch._foreach_mul(mus, lr)
        if all(p.dtype == torch.float32 for p in params):
            torch._foreach_sub_(params, step)
        else:
            torch._foreach_copy_(params, torch._foreach_sub([p.float() for p in params], step))
        state["count"] = count
        return state, dict(grad_norm=gnorm, lr=lr)
