"""The map between the port's LM parameters and the reference's params
tree.

The reference stacks a decoder's layers (``groups``: one leaf of shape
``(L // P, ...)`` per position of the block pattern, the remainder in
``rest``) and an enc-dec's (``enc_layers`` / ``dec_layers``); the port holds
one module per layer.  :func:`lm_param_leaves` lists the reference's
leaves in its flatten order, each with the port parameters that hold it.
The optimizer keeps its state in this layout and ``convert`` restacks
parameters and moments through it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple, Union

import torch

from ..io.checkpoint import keystr


@dataclasses.dataclass(eq=False)
class ParamLeaf:
    """One leaf of the reference's params tree and the port parameters that
    hold it.  A stacked leaf (a decoder's ``groups``, an enc-dec's
    ``enc_layers`` / ``dec_layers``) has ``shape = (len(params),) +
    params[0].shape`` and ``params[g]`` is slice ``g`` of its leading axis;
    any other leaf is its one parameter."""

    path: Tuple[Union[str, int], ...]  # key path in the reference's params
    shape: Tuple[int, ...]  # the reference's (stacked) shape
    params: List[torch.Tensor]
    stacked: bool

    @property
    def name(self) -> str:
        return keystr(self.path)


def _ref_path(cfg, name: str):
    """``(path, stack index or None)`` of the port parameter ``name`` in
    the reference's params tree (the inverse of
    ``convert.lm_params_from_arrays``'s unstacking)."""
    parts = name.split(".")
    if cfg.encdec:
        if parts[0] in ("enc_layers", "dec_layers"):
            return (parts[0], *parts[2:]), int(parts[1])
        return tuple(parts), None
    if parts[0] != "layers":
        return tuple(parts), None
    i, P = int(parts[1]), cfg.pattern_period
    n_groups = cfg.n_layers // P if cfg.layer_stack == "scan" else 0
    if i < n_groups * P:
        return ("groups", i % P, *parts[2:]), i // P
    return ("rest", i - n_groups * P, *parts[2:]), None


def lm_param_leaves(cfg, model) -> List[ParamLeaf]:
    """The reference's params leaves for ``cfg`` in its flatten order (dict
    keys sorted, groups and rest layers in order), each holding the port
    model's parameters it stacks."""
    found: Dict[Tuple, Dict] = {}
    for name, p in model.named_parameters():
        path, idx = _ref_path(cfg, name)
        found.setdefault(path, {})[idx] = p
    leaves = []
    for path in sorted(found):
        slots = found[path]
        if None in slots:
            p = slots[None]
            leaves.append(ParamLeaf(path, tuple(p.shape), [p], False))
        else:
            ps = [slots[g] for g in range(len(slots))]
            leaves.append(ParamLeaf(path, (len(ps),) + tuple(ps[0].shape), ps, True))
    return leaves
