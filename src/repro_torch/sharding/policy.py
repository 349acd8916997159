"""Sharding policy: parameter specs, activation constraints and their
placement on a ``torch.distributed`` device mesh; the counterpart of
``repro/sharding/policy.py``.

Mesh contract (``launch/mesh.py``): ``("data", "model")`` single-pod 16x16
or ``("pod", "data", "model")`` multi-pod 2x16x16; "pod" is an outer pure-DP
axis.  Every rule is divisibility-checked against the actual dim and falls
back to replication, so the policy is total: it never gives a spec that
does not divide.

Parameter rules (Megatron-style TP + optional FSDP), as the reference's:
  * d_ff / expert / vocab / flattened-QKV output dims -> "model";
  * FSDP: the d_model-ish dim additionally -> "data" when the arch is large
    (>= ``fsdp_threshold`` params);
  * MoE experts -> "model" (expert parallelism).

The shape logic is split from the placement of tensors:

  * :func:`make_policy`, :func:`param_spec` and :func:`activation_spec` read
    only an ordered mapping of axis names to sizes (a ``DeviceMesh`` gives
    one) and return the reference's spec as a tuple, one entry a tensor dim:
    ``None``, an axis name or a tuple of names;
  * :func:`placements` turns a spec into DTensor placements on the policy's
    ``DeviceMesh`` (``Shard(d)`` on each mesh dim named at tensor dim ``d``,
    ``Replicate()`` elsewhere), and :func:`shard_model` makes each parameter
    a DTensor by its reference leaf's spec.

A tuple entry such as ``("pod", "data")`` shards one dim over both axes;
DTensor splits it mesh dim by mesh dim, the outer first, so the shard of
mesh coordinate ``(p, d)`` is chunk ``p * data + d``: the block JAX gives
the device at that coordinate.  An entry whose names are out of the mesh's
order has no such DTensor layout and raises.

Activation hints go through :func:`constrain` (the reference's
``with_sharding_constraint``): ``DTensor.redistribute`` to the kind's spec
under an ambient policy (a ``contextvars.ContextVar``), the identity
without one or on a plain tensor.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]

_CTX: contextvars.ContextVar = contextvars.ContextVar("sharding_policy", default=None)


def mesh_shape(mesh) -> Dict[str, int]:
    """The ordered ``{axis name: size}`` of a ``DeviceMesh`` (or of a
    mapping, returned as a dict)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass
class Policy:
    shape: Dict[str, int]  # ordered axis name -> size
    cfg: Any
    batch_axes: Tuple[str, ...]  # ("pod", "data") or ("data",) or ()
    fsdp: bool
    seq_shard: bool  # shard the sequence dim of long activations over "model"
    mesh: Any = None  # the DeviceMesh that places tensors (None: specs only)

    @property
    def model_size(self) -> int:
        return self.shape["model"]

    @property
    def data_size(self) -> int:
        return math.prod(self.shape[a] for a in self.batch_axes) if self.batch_axes else 1


def spec_of(*entries: Entry) -> Spec:
    """A spec from its entries, a one-name tuple written as the name (as a
    ``PartitionSpec`` shows it)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def make_policy(mesh, cfg, global_batch: int, *, fsdp_threshold: int = 8_000_000_000,
                seq_shard: bool = False) -> Policy:
    """``mesh``: a ``DeviceMesh`` with named dims, or a mapping of axis
    names to sizes (specs only, no tensor placement)."""
    shape = mesh_shape(mesh)
    axes = [a for a in ("pod", "data") if a in shape]
    # the largest prefix-product of batch axes that divides global_batch
    chosen: Tuple[str, ...] = ()
    for i in range(len(axes), 0, -1):
        if _div(global_batch, math.prod(shape[a] for a in axes[:i])):
            chosen = tuple(axes[:i])
            break
    return Policy(shape=shape, cfg=cfg, batch_axes=chosen,
                  fsdp=cfg.n_params() >= fsdp_threshold, seq_shard=seq_shard,
                  mesh=None if isinstance(mesh, Mapping) else mesh)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

COL_NAMES = ("wq", "wk", "wv", "w_in", "w_gate", "w_up", "wi", "w1", "w_x", "w_gates", "w_z",
             "w_if", "conv_w")
ROW_NAMES = ("wo", "w_out", "w_down", "w2", "w_o")


def param_spec(pol: Policy, path: str, shape: Tuple[int, ...]) -> Spec:
    """The spec of one parameter, keyed by its path in the reference's
    params tree (``/``-joined keys): leading stack dims (the reference's
    scan over layers) stay unsharded."""
    ms = pol.model_size
    fs = pol.shape.get("data", 1)
    name = path.split("/")[-1]
    nd = len(shape)
    fsdp = pol.fsdp

    def maybe_fsdp(spec, dim):
        """Add 'data' FSDP sharding on ``dim`` if divisible and free."""
        if fsdp and spec[dim] is None and _div(shape[dim], fs):
            spec[dim] = "data"
        return spec

    # norms, biases, scalars, small vectors -> replicated
    if nd <= 1 or "norm" in path or name in ("b", "bias", "a_param"):
        return (None,) * nd
    lead = (None,) * (nd - 2)
    d0, d1 = shape[-2], shape[-1]
    if "emb" in path or name in ("embed", "out_head", "pos_embed"):  # (V, d) or (S, d)
        spec = [None, None]
        if _div(d0, ms) and "pos" not in name:
            spec[0] = "model"
            spec = maybe_fsdp(spec, 1)
        elif _div(d1, ms):
            spec[1] = "model"
        return lead + tuple(spec)
    if name == "w_router":  # (d, E)
        return lead + (None, None)
    if "expert" in path:  # (..., E, d, ff) or (..., E, ff, d)
        e_dim = nd - 3
        spec = [None] * nd
        if _div(shape[e_dim], ms):
            spec[e_dim] = "model"
        elif _div(shape[-1], ms):
            spec[-1] = "model"
        if fsdp and spec[nd - 2] is None and _div(shape[nd - 2], fs):
            spec[nd - 2] = "data"
        return tuple(spec)
    if name in COL_NAMES:
        spec = [None, "model"] if _div(d1, ms) else [None, None]
        return lead + tuple(maybe_fsdp(spec, 0))
    if name in ROW_NAMES:
        spec = ["model", None] if _div(d0, ms) else [None, None]
        return lead + tuple(maybe_fsdp(spec, 1))
    # default: TP on the last dim, FSDP on the first
    spec = [None, "model"] if _div(d1, ms) else [None, None]
    return lead + tuple(maybe_fsdp(spec, 0))


# ---------------------------------------------------------------------------
# Activation specs
# ---------------------------------------------------------------------------

def activation_spec(pol: Policy, kind: str, shape: Tuple[int, ...]) -> Optional[Spec]:
    ms = pol.model_size
    bspec = tuple(pol.batch_axes) if pol.batch_axes else None
    if bspec and shape and not _div(shape[0], pol.data_size):
        bspec = None
    if kind == "btd":  # (B, S, d)
        if pol.seq_shard and len(shape) == 3 and _div(shape[1], ms):
            return spec_of(bspec, "model", None)
        return spec_of(bspec, None, None)
    if kind == "btf":  # (B, S, ff)
        return spec_of(bspec, None, "model") if _div(shape[-1], ms) else spec_of(bspec)
    if kind == "bthd":  # (B, S, H, hd)
        if _div(shape[2], ms):
            return spec_of(bspec, None, "model", None)
        if pol.cfg.ctx_parallel and _div(shape[1], ms) and shape[1] > 1:
            # context parallelism: heads do not divide the model axis, so
            # the query sequence is sharded instead
            return spec_of(bspec, "model", None, None)
        return spec_of(bspec, None, None, None)
    if kind == "logits":  # (B, S, V)
        return spec_of(bspec, None, "model") if _div(shape[-1], ms) else spec_of(bspec)
    if kind == "moe_becd":  # (B, E, C, d)
        e_ok = _div(shape[1], ms)
        d_ok = _div(shape[3], ms)
        return spec_of(bspec, "model" if e_ok else None, None,
                       "model" if (not e_ok and d_ok) else None)
    return None


def _names(e: Entry) -> Tuple[str, ...]:
    return () if e is None else (e,) if isinstance(e, str) else tuple(e)


def local_shape(axes: Mapping[str, int], spec: Spec, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """A shard's shape under ``spec`` on a mesh of ``axes`` (every sharded
    dim divides)."""
    return tuple(n // math.prod(axes[a] for a in _names(spec[i] if i < len(spec) else None))
                 for i, n in enumerate(shape))


def q8_spec(axes: Mapping[str, int], shape: Tuple[int, ...]) -> Spec:
    """An 8-bit moment block tensor's spec (``(L, NB, BLOCK)`` values or
    ``(L, NB, 1)`` scales): its first dim that divides, over the widest
    group of axes it divides (the reference's ``launch/specs.py``
    ``opt_shardings``)."""
    for dim in range(max(len(shape) - 1, 1)):
        for group in (("pod", "data", "model"), ("data", "model"), ("data",), ("model",)):
            if all(a in axes for a in group) and _div(shape[dim],
                                                      math.prod(axes[a] for a in group)):
                spec: list = [None] * len(shape)
                spec[dim] = group
                return spec_of(*spec)
    return ()


# ---------------------------------------------------------------------------
# Placement on the device mesh
# ---------------------------------------------------------------------------

def placements(pol, spec: Spec) -> Tuple:
    """The DTensor placements of ``spec`` on ``pol.mesh`` (``pol`` a
    ``Policy``, or the mesh's ordered ``{axis: size}``): one per mesh dim,
    ``Shard(d)`` where tensor dim ``d`` names it, else ``Replicate()``."""
    names = list(pol.shape if isinstance(pol, Policy) else pol)
    out = [Replicate()] * len(names)
    for d, e in enumerate(spec):
        group = _names(e)
        dims = [names.index(a) for a in group]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {group} is not in the mesh's axis order {names}: "
                             "DTensor has no layout for it")
        for m in dims:
            if out[m] != Replicate():
                raise ValueError(f"mesh axis {names[m]!r} named twice in {spec}")
            out[m] = Shard(d)
    return tuple(out)


def distribute(pol: Policy, x: torch.Tensor, spec: Spec) -> DTensor:
    """``x`` (the same full value on every rank) as a DTensor under
    ``spec``: each rank keeps its own chunk, no collective."""
    rep = DTensor.from_local(x, pol.mesh, [Replicate()] * len(pol.shape), run_check=False)
    return rep.redistribute(pol.mesh, placements(pol, spec))


def leaf_param_specs(pol: Policy, leaves) -> Dict[int, Spec]:
    """``{id(param): spec}`` for the port parameters of ``leaves``
    (``models.lm_param_leaves``): each takes its reference leaf's spec
    without the leading stack dim of a stacked leaf."""
    out = {}
    for leaf in leaves:
        spec = param_spec(pol, "/".join(str(k) for k in leaf.path), leaf.shape)
        for p in leaf.params:
            out[id(p)] = spec[len(spec) - p.dim():] if p.dim() else ()
    return out


def shard_model(pol: Policy, model, leaves=None) -> Dict[str, Spec]:
    """Turn each parameter of ``model`` into a DTensor on ``pol.mesh`` by its
    reference leaf's spec, in place (the module keeps its structure; each
    rank keeps its own chunk of the value it holds, so every rank must hold
    the same weights).  Returns ``{parameter name: spec}``."""
    from ..models.leaves import lm_param_leaves

    specs = leaf_param_specs(pol, leaves if leaves is not None
                             else lm_param_leaves(pol.cfg, model))
    named = {}
    for mod_name, mod in model.named_modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            spec = specs[id(p)]
            d = distribute(pol, p.detach(), spec)
            mod.register_parameter(name, torch.nn.Parameter(d, requires_grad=p.requires_grad))
            named[f"{mod_name}.{name}" if mod_name else name] = spec
    return named


# ---------------------------------------------------------------------------
# Activation constraints (ambient)
# ---------------------------------------------------------------------------

def constrain(x, kind: str):
    """The reference's ``with_sharding_constraint`` by kind: ``x``
    redistributed to the kind's spec under the current policy; the identity
    without a policy, on a plain tensor or for a kind with no spec."""
    pol: Optional[Policy] = _CTX.get()
    if pol is None or not isinstance(x, DTensor):
        return x
    spec = activation_spec(pol, kind, tuple(x.shape))
    if spec is None:
        return x
    return x.redistribute(pol.mesh, placements(pol, spec))


@contextlib.contextmanager
def policy_context(pol: Optional[Policy]):
    """The ambient policy for the model code inside; under a policy with a
    mesh, plain tensors made in the model (positions, masks, zeros) mix
    with DTensors as replicated ones."""
    tok = _CTX.set(pol)
    try:
        if pol is not None and pol.mesh is not None:
            from torch.distributed.tensor.experimental import implicit_replication
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _CTX.reset(tok)


def current_policy() -> Optional[Policy]:
    return _CTX.get()


# ---------------------------------------------------------------------------
# Ops with no DTensor sharding strategy
# ---------------------------------------------------------------------------

REPLICATED: collections.Counter = collections.Counter()


def replicated(name: str, fn, *args):
    """``fn(*args)`` for an op that DTensor has no sharding strategy for
    (GSPMD's own answer): every DTensor argument is redistributed to
    ``Replicate()`` and its local tensor passed, and each tensor in the
    result (a tensor, or a tuple or list of them) comes back as a replicated
    DTensor.  Each such call adds one to ``REPLICATED[name]``.  With no
    DTensor argument it is ``fn(*args)`` and counts nothing.  Errors pass
    through."""
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)), None)
    if mesh is None:
        return fn(*args)
    REPLICATED[name] += 1
    rep = [Replicate()] * mesh.ndim
    local = [a.redistribute(mesh, rep).to_local() if isinstance(a, DTensor) else a
             for a in args]
    out = fn(*local)
    wrap = lambda t: DTensor.from_local(t, mesh, rep, run_check=False) \
        if isinstance(t, torch.Tensor) else t
    if isinstance(out, (tuple, list)):
        return type(out)(wrap(t) for t in out)
    return wrap(out)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., d) @ w (d, f)``; on two DTensors, one matmul of the local
    shards with the layout chosen per mesh dim, as GSPMD's dot rules choose
    it:

      * ``x`` sharded on a row dim: the rows stay sharded, ``w`` is gathered
        there (an FSDP weight's all-gather) and its gradient is a partial
        sum over the rows;
      * ``x`` sharded on ``d``: ``w`` is taken sharded on ``d`` too and the
        result is a ``Partial`` sum (row parallel);
      * ``x`` whole and ``w`` sharded on ``f``: the result is sharded on
        ``f`` (column parallel), ``x``'s gradient a partial sum; ``w``
        sharded on ``d``: ``x`` is split on ``d`` to match;
      * both whole: whole.

    DTensor's own matmul flattens the row dims first, and a row dim over
    one mesh dim with the sequence over another becomes a strided shard
    whose redistribution plan it searches for minutes on a 3-d mesh."""
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return x @ w
    mesh, last = x.device_mesh, x.ndim - 1
    xp, wp = list(x.placements), list(w.placements)
    out, xg, wg = [], [], []
    for m in range(mesh.ndim):
        a = Replicate() if isinstance(xp[m], Partial) else xp[m]
        b = Replicate() if isinstance(wp[m], Partial) else wp[m]
        if isinstance(a, Shard) and a.dim == last:  # row parallel
            xp[m], wp[m] = a, Shard(0)
            out.append(Partial()), xg.append(a), wg.append(Shard(0))
        elif isinstance(a, Shard):  # the rows stay split
            xp[m], wp[m] = a, Replicate()
            out.append(Shard(a.dim)), xg.append(a), wg.append(Partial())
        elif isinstance(b, Shard) and b.dim == 1:  # column parallel
            xp[m], wp[m] = a, b
            out.append(Shard(last)), xg.append(Partial()), wg.append(b)
        elif isinstance(b, Shard):  # w split on d: split x to match
            xp[m], wp[m] = Shard(last), b
            out.append(Partial()), xg.append(Shard(last)), wg.append(b)
        else:
            xp[m], wp[m] = a, b
            out.append(Replicate()), xg.append(Replicate()), wg.append(Replicate())
    xl = x.redistribute(mesh, xp).to_local(grad_placements=xg)
    wl = w.redistribute(mesh, wp).to_local(grad_placements=wg)
    return DTensor.from_local(xl @ wl, mesh, out, run_check=False)


def embedding(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table.index_select(0, tokens)`` as (tokens' shape, d); on a DTensor
    table, a lookup of the local shards (the vocab-parallel embedding).
    Per mesh dim: tokens sharded on the batch keep it, the table is
    gathered there (an FSDP all-gather) and its gradient is a partial sum;
    a table sharded on the vocab looks up only the ids in its rows and
    gives zeros elsewhere, a ``Partial`` sum; a table sharded on ``d`` gives
    the rows sharded on ``d``.  Older DTensor's ``index_select`` takes the
    whole index against the local gradient in the backward."""
    if not isinstance(table, DTensor):
        rows = table.index_select(0, tokens.reshape(-1).long())
        return rows.reshape(tuple(tokens.shape) + (-1,))
    mesh, ndim = table.device_mesh, tokens.ndim
    rep = [Replicate()] * mesh.ndim
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, rep, run_check=False)
    tp, xp, out, tg = [], [], [], []
    vocab = None  # (mesh dim, its size) sharding the vocab
    for m, size in enumerate(mesh.shape):
        a, b = tokens.placements[m], table.placements[m]
        if isinstance(a, Shard):  # the tokens' rows stay split, the table whole
            xp.append(a), tp.append(Replicate()), out.append(Shard(a.dim)), tg.append(Partial())
        elif isinstance(b, Shard) and b.dim == 0 and vocab is None:
            vocab = (m, size)
            xp.append(Replicate()), tp.append(b), out.append(Partial()), tg.append(b)
        elif isinstance(b, Shard) and b.dim == 1:
            xp.append(Replicate()), tp.append(b), out.append(Shard(ndim)), tg.append(b)
        else:
            xp.append(Replicate()), tp.append(Replicate()), out.append(Replicate())
            tg.append(Replicate())
    t_l = table.redistribute(mesh, tp).to_local(grad_placements=tg)
    ids = tokens.redistribute(mesh, xp).to_local().long()
    if vocab is not None:
        rows_l = t_l.shape[0]
        ids = ids - mesh.get_local_rank(vocab[0]) * rows_l
        mine = (ids >= 0) & (ids < rows_l)
        got = t_l.index_select(0, torch.where(mine, ids, 0).reshape(-1))
        got = torch.where(mine.reshape(-1, 1), got, 0)
    else:
        got = t_l.index_select(0, ids.reshape(-1))
    return DTensor.from_local(got.reshape(tuple(ids.shape) + (-1,)), mesh, out, run_check=False)


def attend(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, **kw) -> torch.Tensor:
    """``fn(q, k, v, **kw)`` (``sdpa`` or ``chunked_attention``: q (B, Sq, H,
    hd), k/v (B, Sk, KV, hd)) on the local shards.  Per mesh dim: a batch
    dim sharded in any of the three is sharded in all; heads stay sharded
    where the kv heads split the same way (rank r then holds the query
    heads that read its kv heads); a sharded sequence, key or query, is
    gathered (the softmax runs over whole keys, and the masks read global
    positions), as is everything else.  Each output element depends only on
    its rank's inputs, so no gradient is a partial sum.  DTensor's own
    einsum flattens sharded dims, which older DTensor refuses."""
    if not any(isinstance(t, DTensor) for t in (q, k, v)):
        return fn(q, k, v, **kw)
    mesh = next(t.device_mesh for t in (q, k, v) if isinstance(t, DTensor))
    rep = [Replicate()] * mesh.ndim
    q, k, v = (t if isinstance(t, DTensor) else DTensor.from_local(t, mesh, rep, run_check=False)
               for t in (q, k, v))
    H, KV = q.shape[2], k.shape[2]
    place, heads = [], 1
    for m, size in enumerate(mesh.shape):
        ps = (q.placements[m], k.placements[m], v.placements[m])
        if any(isinstance(p, Shard) and p.dim == 0 for p in ps):
            place.append(Shard(0))
        elif (isinstance(q.placements[m], Shard) and q.placements[m].dim == 2
              and H % (heads * size) == 0 and KV % (heads * size) == 0):
            heads *= size
            place.append(Shard(2))
        else:
            place.append(Replicate())
    local = [t.redistribute(mesh, place).to_local() for t in (q, k, v)]
    return DTensor.from_local(fn(*local, **kw), mesh, place, run_check=False)


def split_last(y: torch.Tensor, *dims: int) -> torch.Tensor:
    """``y`` with its last dim split into ``dims`` (heads, head dim).  A
    DTensor sharded on that dim over mesh dims whose sizes do not divide
    ``dims[0]`` has no layout after the split (a shard would hold part of a
    head): that dim is gathered first, as GSPMD replicates it."""
    if isinstance(y, DTensor):
        last = y.ndim - 1
        keep, n = [], 1
        for size, p in zip(y.device_mesh.shape, y.placements):
            ok = not (isinstance(p, Shard) and p.dim == last) or dims[0] % (n * size) == 0
            if ok and isinstance(p, Shard) and p.dim == last:
                n *= size
            keep.append(p if ok else Replicate())
        if keep != list(y.placements):
            y = y.redistribute(y.device_mesh, keep)
    return y.reshape(*y.shape[:-1], *dims)


def assign_(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst.copy_(src)`` in place; a DTensor ``src`` is first redistributed
    to ``dst``'s placements (an in-place op keeps its target's layout)."""
    if isinstance(dst, DTensor) and isinstance(src, DTensor) \
            and src.placements != dst.placements:
        src = src.redistribute(dst.device_mesh, dst.placements)
    return dst.copy_(src)
