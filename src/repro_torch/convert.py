"""Carry networks and step state across from the reference's arrays.

Plain functions on numpy arrays (never on objects of the JAX package), so
one identical network and one identical mid-run state can be fed to both
packages:

  * :func:`network_from_arrays` builds the port's ``DCSRNetwork`` from the
    reference's partition arrays, registry entries and meta;
  * :func:`carry_from_arrays` builds the port's step carry from the
    reference ``Simulator``'s carry, or the list of per-partition carries
    of the port's ``DistSimulator`` from the reference ``DistSimulator``'s
    stacked ``(k, ...)`` carry;
  * :func:`lm_params_from_arrays` and :func:`lm_cache_from_arrays` carry an
    LM's parameters and a prefilled cache across from the reference's
    pytrees (nested dicts, lists and tuples of numpy arrays);
    :func:`lm_params_to_arrays` restacks a port model's parameters into the
    reference's params tree, and :func:`lm_opt_state_to_arrays` /
    :func:`lm_opt_state_from_arrays` carry an optimizer state (fp32 or
    8-bit moments) both ways, through ``models.leaves.lm_param_leaves``,
    the map between the two layouts.  What they return holds copies,
    never views of a live parameter or moment; a DTensor (a sharded run's
    parameter or moment) is gathered whole first, so every rank gets the
    tree an unsharded run would write.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

from .core.dcsr import DCSRNetwork, DCSRPartition
from .core.state import ModelRegistry
from .io.checkpoint import host_array
from .models.leaves import ParamLeaf, lm_param_leaves

_PART_KEYS = (
    "row_ptr", "col_idx", "vtx_model", "vtx_state", "edge_model",
    "edge_state", "coords", "global_ids",
)


def network_from_arrays(
    *,
    parts: Sequence[Mapping[str, object]],
    registry_entries: Sequence[Tuple[str, str, int, Dict[str, float]]],
    var_names: Mapping[str, Tuple[str, ...]],
    meta: Mapping[str, float],
) -> DCSRNetwork:
    """``parts[p]`` holds partition p's ``row_start`` and the arrays named in
    ``_PART_KEYS``; ``registry_entries`` is ``ModelRegistry.to_entries()``
    and ``var_names`` maps each model name to its state-variable names.
    The arrays are copied, so later changes on either side stay there."""
    registry = ModelRegistry.from_entries(registry_entries, dict(var_names))
    out = []
    for p, arrs in enumerate(parts):
        out.append(DCSRPartition(
            part_id=p,
            row_start=int(arrs["row_start"]),
            **{k: np.array(arrs[k], copy=True) for k in _PART_KEYS},
        ))
    dist = np.concatenate(
        [[0], np.cumsum([part.n for part in out])]
    ).astype(np.int64)
    net = DCSRNetwork(dist=dist, parts=out, registry=registry, meta=dict(meta))
    net.validate()
    return net


def carry_from_arrays(
    *,
    t: int,
    vtx_state: np.ndarray,
    ring: np.ndarray,
    hist: np.ndarray,
    weights: Sequence[np.ndarray],
    tr_plus: np.ndarray,
    tr_minus: np.ndarray,
    device,
) -> Union[Dict, List[Dict]]:
    """The port's step carry on ``device`` from the reference carry's
    arrays (``t`` as a host int, made the carry's 0-d int64 tensor; the
    tensors in the reference's dtypes).

    A stacked carry of the reference ``DistSimulator`` (``vtx_state`` of
    shape ``(k, n_p, S)``, every other array with the same leading
    partition axis) gives the list of k per-partition carries that the
    port's ``DistSimulator`` runs; ``device`` is then one device for all
    partitions or a sequence of k."""
    def put(a, dtype, dev):
        return torch.as_tensor(np.array(a, copy=True), dtype=dtype, device=dev)

    def one(p, dev):
        pick = (lambda a: np.asarray(a)) if p is None else (lambda a: np.asarray(a)[p])
        return dict(
            t=torch.tensor(int(t), dtype=torch.int64, device=dev),
            vtx_state=put(pick(vtx_state), torch.float32, dev),
            ring=put(pick(ring), torch.float32, dev),
            hist=put(pick(hist), torch.uint8, dev),
            weights=tuple(put(pick(w), torch.float32, dev) for w in weights),
            tr_plus=put(pick(tr_plus), torch.float32, dev),
            tr_minus=put(pick(tr_minus), torch.float32, dev),
        )

    if np.ndim(vtx_state) == 2:
        return one(None, device)
    k = np.shape(vtx_state)[0]
    devices = [device] * k if isinstance(device, (str, torch.device)) else list(device)
    if len(devices) != k:
        raise ValueError(f"{len(devices)} devices for a carry of {k} partitions")
    return [one(p, dev) for p, dev in enumerate(devices)]


def _tensor(a) -> torch.Tensor:
    """A numpy array (bf16 ones included, which numpy holds as ml_dtypes'
    ``bfloat16``) as a CPU tensor of the same dtype and values."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_state_dict(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A reference pytree of arrays as a ``state_dict``: each leaf under its
    dotted path (list and tuple entries by index), as a CPU tensor.  The
    port's modules name their parameters after the reference's keys, so
    this loads a module's counterpart: ``module.load_state_dict(
    tree_state_dict(jax_params))``."""
    return {k: _tensor(v) for k, v in _flatten(tree, prefix, {}).items()}


def _flatten(tree, prefix: str, out: Dict[str, Any]) -> Dict[str, Any]:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            _flatten(v, f"{prefix}.{k}" if prefix else str(k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}.{i}", out)
    else:
        out[prefix] = tree
    return out


def _unstack_layers(cfg, tree) -> List[Any]:
    """The reference DecoderLM's per-layer subtrees in layer order: layer
    ``g * P + j`` is ``tree["groups"][j]`` at index ``g`` of its leading
    axis, for the ``cfg.n_layers // P`` full groups when ``layer_stack ==
    "scan"`` (``repro/models/transformer.py:140-165``), then
    ``tree["rest"]``."""
    P = cfg.pattern_period
    n_groups = cfg.n_layers // P if cfg.layer_stack == "scan" else 0
    layers = []
    for g in range(n_groups):
        for j in range(P):
            layers.append(_tree_map(lambda a, g=g: np.asarray(a)[g], tree["groups"][j]))
    return layers + list(tree["rest"])


def lm_params_from_arrays(cfg, tree) -> Dict[str, torch.Tensor]:
    """The port model's ``state_dict`` (CPU tensors in the arrays' dtypes;
    ``model.load_state_dict`` casts and moves them) from the reference's
    params for ``cfg``.  A decoder's ``groups`` are unstacked into layers
    (``_unstack_layers``), the enc-dec's ``enc_layers``/``dec_layers``
    along their leading axis; every other key keeps its path."""
    if cfg.encdec:
        flat: Dict[str, Any] = {}
        for key, sub in tree.items():
            if key in ("enc_layers", "dec_layers"):
                n = cfg.enc_layers if key == "enc_layers" else cfg.n_layers
                for i in range(n):
                    _flatten(_tree_map(lambda a, i=i: np.asarray(a)[i], sub), f"{key}.{i}", flat)
            else:
                _flatten(sub, key, flat)
    else:
        flat = {}
        for key in ("emb", "ln_f"):
            _flatten(tree[key], key, flat)
        for i, layer in enumerate(_unstack_layers(cfg, tree)):
            _flatten(layer, f"layers.{i}", flat)
    return {k: _tensor(v) for k, v in flat.items()}


def lm_cache_from_arrays(cfg, tree):
    """The port's cache on the CPU from the reference's: for a decoder
    the list of per-layer dicts (unstacked as the params are), for the
    enc-dec the dict of ``(L, B, S, KV, hd)`` stacks as it is."""
    if cfg.encdec:
        return {k: _tensor(v) for k, v in tree.items()}
    return [_tree_map(_tensor, dict(layer)) for layer in _unstack_layers(cfg, tree)]


# -- the LM's params and optimizer state in the reference's leaf layout ------

def _params_tree(cfg, leaves: Sequence[ParamLeaf], values: Sequence[Any]):
    """``values[i]`` at ``leaves[i].path`` in the reference's tree: a
    decoder's ``groups`` a tuple of ``P`` dicts and its ``rest`` a list."""
    root: Dict[Any, Any] = {}
    for leaf, v in zip(leaves, values, strict=True):
        node = root
        for k in leaf.path[:-1]:
            node = node.setdefault(k, {})
        node[leaf.path[-1]] = v
    if not cfg.encdec:
        if "groups" in root:
            root["groups"] = tuple(root["groups"][j] for j in range(cfg.pattern_period))
        rest = root.get("rest", {})
        root["rest"] = [rest[i] for i in range(len(rest))]
    return root


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (``full_tensor``: every rank gets the full
    value), else ``t``; a sharded run's checkpoint so holds the bytes of an
    unsharded one."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _leaf_array(leaf: ParamLeaf) -> np.ndarray:
    if leaf.stacked:
        return host_array(torch.stack([_whole(p.detach()) for p in leaf.params]))
    return host_array(_whole(leaf.params[0].detach()))


def lm_params_to_arrays(cfg, model):
    """The reference's params tree for ``cfg`` (numpy arrays on the host)
    from the port model's parameters: the inverse of
    :func:`lm_params_from_arrays`, the layers restacked into ``groups``
    (``enc_layers`` / ``dec_layers``)."""
    leaves = lm_param_leaves(cfg, model)
    return _params_tree(cfg, leaves, [_leaf_array(leaf) for leaf in leaves])


_OPT_SKIP = ("count", "leaves")


def lm_opt_state_to_arrays(cfg, state, like: bool = False):
    """The reference optimizer's state tree from the port's (``AdamW``:
    ``dict(m, v, count)``, each moment a params tree of fp32 arrays in the
    stacked shapes or of ``{"q", "scale"}`` dicts; ``SGDM``: ``dict(mu,
    count)``).  With ``like`` the same structure holding 0s, no copies (a
    ``CheckpointManager.restore`` structure)."""
    conv = (lambda x: 0) if like else (lambda x: host_array(_whole(x)))
    out: Dict[str, Any] = {"count": conv(state["count"])}
    for key, per_leaf in state.items():
        if key in _OPT_SKIP:
            continue
        vals = [{k: conv(t) for k, t in x.items()} if isinstance(x, Mapping) else conv(x)
                for x in per_leaf]
        out[key] = _params_tree(cfg, state["leaves"], vals)
    return out


def lm_opt_state_from_arrays(cfg, model, tree) -> Dict[str, Any]:
    """The port optimizer's state for ``model`` from the reference's state
    tree (see :func:`lm_opt_state_to_arrays`), on the model's device."""
    leaves = lm_param_leaves(cfg, model)
    dev = leaves[0].params[0].device

    def put(a):
        return _tensor(a).to(dev)

    def at(node, path):
        for k in path:
            node = node[k]
        return node

    state: Dict[str, Any] = {"leaves": leaves,
                             "count": put(tree["count"]).to(torch.int32).reshape(())}
    for key, sub in tree.items():
        if key == "count":
            continue
        vals = [at(sub, leaf.path) for leaf in leaves]
        state[key] = [{k: put(x) for k, x in v.items()} if isinstance(v, Mapping) else put(v)
                      for v in vals]
    return state


def lm_train_tree(cfg, model, state, like: bool = False):
    """The reference train launcher's checkpoint tree, ``dict(params=...,
    opt_state=...)`` in its layouts; with ``like`` the structure only (0s,
    no copies)."""
    if like:
        leaves = lm_param_leaves(cfg, model)
        params = _params_tree(cfg, leaves, [0] * len(leaves))
    else:
        params = lm_params_to_arrays(cfg, model)
    return dict(params=params, opt_state=lm_opt_state_to_arrays(cfg, state, like=like))
