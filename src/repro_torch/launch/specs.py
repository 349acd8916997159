"""Input, cache, parameter and optimizer-state specs for every (arch x
shape) cell, the counterpart of ``repro/launch/specs.py``.

Where the reference returns ``ShapeDtypeStruct`` trees and
``NamedSharding``s, the port returns meta tensors (a shape and a dtype, no
data) and spec tuples (``sharding.policy``: one entry a dim, ``None``, an
axis name or a tuple of names); ``sharding.policy.placements`` turns a spec
into DTensor placements.  The parameters and the optimizer state are in
the reference's leaf layout (``models.lm_param_leaves``: a decoder's
layers stacked into ``groups``); the caches are the port's (one dict a
layer for a decoder, stacked for an enc-dec), and a decoder layer's cache
entry takes the spec the reference gives its stacked leaf, without the
stack dim.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..configs.base import ArchConfig, ShapeCell
from ..models import build_model, lm_param_leaves
from ..models.layers import dtype_of
from ..sharding.policy import Policy, Spec, _div, param_spec, q8_spec, spec_of


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_spec(pol: Policy):
    return tuple(pol.batch_axes) if pol.batch_axes else None


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, cell: ShapeCell) -> Dict[str, torch.Tensor]:
    """The model's data inputs (tokens, frames, img_embed; a decode step's
    token and position) as meta tensors."""
    B, S = cell.global_batch, cell.seq_len
    cdt = dtype_of(cfg.compute_dtype)
    if cell.kind in ("train", "prefill"):
        if cfg.encdec:
            return dict(frames=meta((B, S, cfg.d_model), cdt), tokens=meta((B, S), torch.int32))
        if cfg.n_img_tokens:
            return dict(tokens=meta((B, S - cfg.n_img_tokens), torch.int32),
                        img_embed=meta((B, cfg.n_img_tokens, cfg.d_model), cdt))
        return dict(tokens=meta((B, S), torch.int32))
    return dict(token=meta((B, 1), torch.int32), pos=meta((), torch.int32))


def input_shardings(cfg: ArchConfig, cell: ShapeCell, pol: Policy) -> Dict[str, Spec]:
    b = batch_spec(pol)
    return {k: spec_of(b, *(None,) * (v.dim() - 1)) if k != "pos" and v.dim() >= 2 else ()
            for k, v in input_specs(cfg, cell).items()}


# ---------------------------------------------------------------------------
# Caches (decode cells)
# ---------------------------------------------------------------------------

def abstract_model(cfg: ArchConfig):
    """The model with its parameters on the meta device (shapes only)."""
    return build_model(cfg, device="meta")


def cache_specs(model, cfg: ArchConfig, cell: ShapeCell):
    """The cache of a decode cell as meta tensors (``model`` on the meta
    device)."""
    B, S = cell.global_batch, cell.seq_len
    return model.init_cache(B, S, S) if cfg.encdec else model.init_cache(B, S)


def cache_spec(pol: Policy, shape: Tuple[int, ...], batch: int) -> Spec:
    """A cache tensor's spec: its first dim equal to the batch over the
    batch axes; a KV cache's sequence dim (``ndim - 3``) over "model" where
    it divides (the reference: it keeps a 32k cache on-chip, and decode
    attention pays an all-gather).  Recurrent states: batch only."""
    b = batch_spec(pol)
    spec: List[Any] = [None] * len(shape)
    if b is not None:
        for i, d in enumerate(shape):
            if d == batch:
                spec[i] = b
                break
    if len(shape) >= 3:
        s = len(shape) - 3
        if spec[s] is None and shape[s] > 1 and _div(shape[s], pol.model_size):
            spec[s] = "model"
    return spec_of(*spec)


def cache_shardings(cache, cfg: ArchConfig, cell: ShapeCell, pol: Policy):
    """``cache_spec`` over the cache's structure."""
    one = lambda x: cache_spec(pol, tuple(x.shape), cell.global_batch)
    if isinstance(cache, dict):
        return {k: one(v) for k, v in cache.items()}
    return [{k: one(v) for k, v in layer.items()} for layer in cache]


# ---------------------------------------------------------------------------
# Parameters and optimizer state
# ---------------------------------------------------------------------------

def params_specs(model, cfg: ArchConfig):
    """The reference's parameter leaves (``ParamLeaf``: path, stacked shape
    and the port parameters it stacks)."""
    return lm_param_leaves(cfg, model)


def leaf_path(leaf) -> str:
    return "/".join(str(k) for k in leaf.path)


def param_shardings(pol: Policy, leaves) -> List[Spec]:
    """One spec a leaf, in its stacked shape."""
    return [param_spec(pol, leaf_path(leaf), leaf.shape) for leaf in leaves]


def opt_specs(optimizer, leaves):
    """The optimizer's state for ``leaves`` (meta parameters give meta
    moments)."""
    return optimizer.init(leaves)


def opt_shardings(opt_state, p_specs: List[Spec], pol: Policy, optimizer) -> Dict[str, Any]:
    """Adam's ``m``/``v`` (SGDM's ``mu``) take the parameter specs; 8-bit
    blocks shard their leading dim as widely as it divides
    (``sharding.policy.q8_spec``); ``count`` is replicated."""
    if getattr(optimizer, "quantize_moments", False):
        q8 = lambda sub: [{k: q8_spec(pol.shape, tuple(x.shape)) for k, x in d.items()}
                          for d in sub]
        return dict(m=q8(opt_state["m"]), v=q8(opt_state["v"]), count=())
    if "v" in opt_state:
        return dict(m=list(p_specs), v=list(p_specs), count=())
    return dict(mu=list(p_specs), count=())


def local_bytes(tensors) -> int:
    """The bytes of this rank's shards of ``tensors`` (DTensors' local
    tensors, plain tensors whole)."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in tensors:
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()
    return total


def tensors_of(tree) -> List[torch.Tensor]:
    """Every tensor in a tree of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    return []


__all__ = [
    "abstract_model", "batch_spec", "cache_shardings", "cache_spec", "cache_specs",
    "input_shardings", "input_specs", "leaf_path", "local_bytes", "opt_shardings", "opt_specs",
    "param_shardings", "params_specs", "tensors_of",
]
