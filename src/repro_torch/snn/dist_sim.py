"""The k > 1 engine: k partitions of a uniform dCSR net, each on a device of
its own or all on one card, stepped in lockstep in one process.

Counterpart of ``repro/snn/dist_sim.py:DistSimulator``, where each partition
runs on a device of a ``shard_map`` mesh and the exchange is a collective.
Here the k partitions are driven by one Python loop: every step runs each
partition's pre-exchange half (``make_core_step``'s ``step.pre``), then the
exchange over all partitions, then each partition's post-exchange half
(``step.post``).  ``devices`` may repeat one card (``["cuda:0"] * k``, how
one H100 runs k partitions) or name the CPU (``["cpu"] * k``, how the tests
run them), the counterpart of the reference's ``mesh=`` over fake host
devices.  The exchange is a concatenation:

  * ``dense``: the partitions' spike vectors, concatenated (and their
    ``tr_plus`` on plastic nets) into the ``(n_global,)`` activity;
  * ``index``: each partition compacts its spike ids into a buffer of
    ``index_cap = max(int(index_cap_frac * n_p), 8)`` ids, keeping the
    lowest ids past the cap (the reference's ``jnp.nonzero(size=cap)``),
    the ids are scattered as 1.0 into the activity, and the spikes dropped
    past the cap are counted per partition and step (``outs['overflow']``).

Every partition receives the same activity on its own device.  Each
partition draws the noise of a step at its own rows' permanent ids, on its
own device, in the launch that adds it to its ring slot (the step front,
``ops.step_front``, on the split engines; ``ops.step_noise_add`` on
``unfused``); a row's value is the one its id has in the step's
``(n_global,)`` vector, so a trajectory is the k = 1 run's of
``merge_to_single(net)``.  The ``_noise_fn`` seam draws that vector once a
step and each partition takes its rows from it.

Requires uniform partitions (``to_dcsr(..., uniform=True)``): with equal
blocks, partition-contiguous global ids are ``p * n_p + local id`` and the
exchanged vector is exactly the merged net's labelling.  The state is a
list of k per-partition carries (the k = 1 carry's keys).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.dcsr import DCSRNetwork
from ..core.ell import build_delay_ell
from ..kernels.dispatch import (
    StepEngineChoice, backend_for, panel_reduce, resolve_device, select_step_engine,
)
from ..kernels.event_step import EventPlan, event_id_cap
from .neurons import LIF_V
from .reshard import RUNTIME_KEYS, stack_runtime
from .simulator import (
    PartitionDeviceData, SimConfig, _models_present, checked_cols, load_runtime_arrays,
    make_core_step, make_noise, plastic_masks, row_lengths, state_reduce,
)


@dataclasses.dataclass
class StackedNet:
    """Per-delay stacked host arrays; the leading axis is the partition."""

    n_p: int
    k: int
    delays: Tuple[int, ...]
    cols: List[np.ndarray]  # per delay (k, R, K) int32
    weights: List[np.ndarray]  # per delay (k, R, K) f32
    plastic: Optional[List[np.ndarray]]  # per delay (k, R, K) f32; None if no STDP
    valid: List[np.ndarray]  # per delay (k, R, K) bool
    vtx_model: np.ndarray  # (k, n_p)
    vtx_state0: np.ndarray  # (k, n_p, S)
    d_ring: int
    identity_rows: bool  # all buckets row-identity

    @property
    def any_plastic(self) -> bool:
        return self.plastic is not None


def stack_partitions(net: DCSRNetwork, cfg: SimConfig) -> StackedNet:
    """Each partition's delay-bucketed ELL, padded to the largest R and
    per-delay K over the partitions and stacked (``dist_sim.py:91-154`` of
    the reference; the ``valid`` masks are bool, and the plastic masks exist
    only for nets with a ``syn_stdp`` edge)."""
    n_ps = {p.n for p in net.parts}
    if len(n_ps) != 1:
        raise ValueError(
            "the k>1 engine needs uniform partitions; build with "
            "to_dcsr(..., uniform=True)"
        )
    n_p = n_ps.pop()
    k = net.k
    ells = [
        build_delay_ell(p, net.n, align_k=cfg.align_k, align_rows=cfg.align_rows)
        for p in net.parts
    ]
    stdp_id = net.registry.edge_id("syn_stdp")
    masks = [plastic_masks(p, e, stdp_id) for p, e in zip(net.parts, ells)]
    any_plastic = any(m is not None for m in masks)
    delays = sorted({b.delay for e in ells for b in e.buckets})
    R = max(
        [b.cols.shape[0] for e in ells for b in e.buckets]
        + [-(-n_p // cfg.align_rows) * cfg.align_rows]
    )
    cols, weights, plastic, valid = [], [], [], []
    for d in delays:
        found = [
            [(i, b) for i, b in enumerate(e.buckets) if b.delay == d] for e in ells
        ]
        K = max((f[0][1].cols.shape[1] for f in found if f), default=cfg.align_k)
        c = np.zeros((k, R, K), np.int32)
        w = np.zeros((k, R, K), np.float32)
        v = np.zeros((k, R, K), bool)
        pm = np.zeros((k, R, K), np.float32) if any_plastic else None
        for p, f in enumerate(found):
            if not f:
                continue
            i, b = f[0]
            r, kk = b.cols.shape
            c[p, :r, :kk] = b.cols
            w[p, :r, :kk] = b.weights
            v[p, :r, :kk] = b.valid
            if masks[p] is not None:
                pm[p, :r, :kk] = masks[p][i]
        cols.append(c)
        weights.append(w)
        valid.append(v)
        if any_plastic:
            plastic.append(pm)
    return StackedNet(
        n_p=n_p, k=k, delays=tuple(delays),
        cols=cols, weights=weights, plastic=plastic if any_plastic else None,
        valid=valid,
        vtx_model=np.stack([p.vtx_model for p in net.parts]),
        vtx_state0=np.stack([p.vtx_state for p in net.parts]),
        d_ring=max(max(delays, default=1), 1),
        identity_rows=all(b.identity_rows for e in ells for b in e.buckets),
    )


def _ownership_masks(s: StackedNet):
    """Per delay the ``(is_local, is_remote)`` bool ``(k, R, K)`` masks of
    the valid slots whose source the partition owns, and of the others."""
    own_lo = (np.arange(s.k) * s.n_p)[:, None, None]
    for c, v in zip(s.cols, s.valid):
        is_local = v & (c >= own_lo) & (c < own_lo + s.n_p)
        yield is_local, v & ~is_local


def split_overlap_panels(
    s: StackedNet, align_k: int
) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray], List[np.ndarray]]:
    """Split each stacked panel by column ownership for the non-plastic
    overlap engines (``dist_sim.py:157-204`` of the reference).

    Local panels hold LOCAL ids (``global - p * n_p``), gathered from the
    own ``(n_p,)`` spike vector; remote panels keep global ids and reference
    only other partitions (padding points at col 0 with weight 0).  Packing
    is a stable argsort, so the entries keep their panel order, with K
    padded to the largest per-row count over rows and partitions, aligned up
    to ``align_k``.  Returns ``(cols_local, weights_local, cols_remote,
    weights_remote)``, each a per-delay list of ``(k, R, K_out)`` arrays."""
    def align(x):
        return max(-(-x // align_k) * align_k, align_k)

    own_lo = (np.arange(s.k) * s.n_p)[:, None, None]
    cols_l, w_l, cols_r, w_r = [], [], [], []
    for c, w, (is_local, is_remote) in zip(s.cols, s.weights, _ownership_masks(s)):
        for mask, out_c, out_w, localize in (
            (is_local, cols_l, w_l, True),
            (is_remote, cols_r, w_r, False),
        ):
            cnt = mask.sum(axis=2)  # (k, R)
            k_out = align(int(cnt.max()) if cnt.size else 0)
            order = np.argsort(~mask, axis=2, kind="stable")[:, :, :k_out]
            cs = np.take_along_axis(c, order, axis=2)
            ws = np.take_along_axis(w, order, axis=2)
            ms = np.take_along_axis(mask, order, axis=2)
            if k_out > cs.shape[2]:
                pad = ((0, 0), (0, 0), (0, k_out - cs.shape[2]))
                cs, ws, ms = (np.pad(a, pad) for a in (cs, ws, ms))
            if localize:
                cs = cs - own_lo
            out_c.append(np.where(ms, cs, 0).astype(np.int32))
            out_w.append(np.where(ms, ws, 0.0).astype(np.float32))
    return cols_l, w_l, cols_r, w_r


def overlap_row_lengths(s: StackedNet) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """``(row_len_local, row_len_remote)``: per delay the ``(k, R)`` int32
    count of each row's slots in the local and in the remote sub-panel of
    :func:`split_overlap_panels`, which puts a row's entries first: its
    row length."""
    local, remote = [], []
    for is_local, is_remote in _ownership_masks(s):
        local.append(is_local.sum(axis=2, dtype=np.int32))
        remote.append(is_remote.sum(axis=2, dtype=np.int32))
    return local, remote


def compact_spike_ids(spikes: torch.Tensor, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ids, dropped)``: the first ``cap`` spiking ids in ascending order,
    ``len(spikes)`` in the unused slots, and the int32 count of spikes past
    the cap -- the reference's ``jnp.nonzero(size=cap)``, with a prefix sum
    so the compaction keeps the order and never reads back to the host."""
    n = spikes.shape[0]
    on = spikes > 0
    pos = torch.cumsum(on, 0) - 1  # the slot of each spike, in id order
    keep = on & (pos < cap)
    ids = torch.full((cap + 1,), n, dtype=torch.int64, device=spikes.device)
    # slot `cap` collects every id that is not kept, and is cut off
    ids.scatter_(0, torch.where(keep, pos, cap),
                 torch.arange(n, dtype=torch.int64, device=spikes.device))
    dropped = on.sum(dtype=torch.int32) - keep.sum(dtype=torch.int32)
    return ids[:cap], dropped


def _scatter_ones(ids: torch.Tensor, n: int) -> torch.Tensor:
    """A ``(n,)`` f32 vector with 1.0 at ``ids`` (ids ``>= n`` dropped)."""
    out = torch.zeros(n + 1, dtype=torch.float32, device=ids.device)
    return out.index_fill_(0, ids.clamp_max(n), 1.0)[:n]


class DistSimulator:
    """k partitions of a uniform net on ``devices`` (one per partition; a
    device may repeat).  With ``devices=None`` each partition takes a card
    of its own, and fewer than k cards raise.  ``_noise_fn`` is the noise
    seam of :class:`Simulator`.  ``_share``, another ``DistSimulator`` of
    the same net, alignments and devices, lends its host panels, device
    panels and touch bitmaps instead of building them again (no engine
    writes into them), so several engines can be compared on one build."""

    def __init__(
        self,
        net: DCSRNetwork,
        cfg: Optional[SimConfig] = None,
        *,
        devices: Optional[Sequence] = None,
        _noise_fn: Optional[Callable[[int], object]] = None,
        _share: Optional["DistSimulator"] = None,
    ):
        cfg = SimConfig() if cfg is None else cfg
        self.net = net
        self.cfg = cfg
        k = net.k
        if devices is None:
            if not torch.cuda.is_available() or torch.cuda.device_count() < k:
                raise RuntimeError(
                    f"{k} partitions need {k} CUDA cards, or devices=[...] naming "
                    "where each runs (a card may repeat; 'cpu' for the plain versions)"
                )
            devices = [f"cuda:{i}" for i in range(k)]
        self.devices = [resolve_device(d) for d in devices]
        if len(self.devices) != k:
            raise ValueError(f"{len(self.devices)} devices for {k} partitions")
        backends = {backend_for(d) for d in self.devices}
        if len(backends) != 1:
            raise ValueError(f"devices {self.devices} mix the CPU and CUDA cards")
        self.backend = backends.pop()
        self.dt = float(net.meta.get("dt", 0.1))
        self.noise_sigma = float(net.meta.get("noise_sigma", 0.0))
        if _share is not None and (
            _share.net is not net or _share.devices != self.devices
            or (_share.cfg.align_k, _share.cfg.align_rows, _share.cfg.event_cap_frac)
            != (cfg.align_k, cfg.align_rows, cfg.event_cap_frac)
        ):
            raise ValueError("_share needs the same net, devices, alignments and event cap")
        self.stacked = s = stack_partitions(net, cfg) if _share is None else _share.stacked
        self.stdp_params = (
            dict(net.registry.spec("syn_stdp").params) if s.any_plastic else None
        )
        # 'auto': the compressed index exchange for non-plastic k > 1, dense
        # otherwise (dist_sim.py:245-249 of the reference)
        self.exchange = cfg.exchange
        if self.exchange == "auto":
            self.exchange = "index" if (k > 1 and not s.any_plastic) else "dense"
        self.index_cap = (
            max(int(cfg.index_cap_frac * s.n_p), 8) if self.exchange == "index" else 0
        )
        self.n_global = k * s.n_p
        self.d_ring = s.d_ring
        self._models = _models_present(net)
        self._sel = dict(
            backend=self.backend,
            models_present=self._models,
            identity_rows=s.identity_rows,
            n_delay_buckets=len(s.delays),
            any_plastic=s.any_plastic,
            identity_exchange=(k == 1 and self.exchange == "dense"),
            n_global=self.n_global,
            fused=cfg.fused,
            overlap=cfg.overlap,
        )
        choice = select_step_engine(
            gather="dense" if cfg.gather == "auto" else cfg.gather, **self._sel
        )
        self.overlap = choice.overlap
        # the non-plastic overlap engines gather build-time ownership
        # sub-panels; plastic panels stay whole (weights are state)
        need_sub = choice.overlap != "off" and not choice.plastic
        if _share is not None and (_share.devs[0].cols_local is not None or not need_sub):
            self.devs = _share.devs
        else:
            opan = (split_overlap_panels(s, cfg.align_k) + overlap_row_lengths(s)
                    if need_sub else None)
            self.devs = [self._device_data(p, opan) for p in range(k)]
        self._noise_ids = [
            torch.from_numpy(part.global_ids).to(dev)
            for part, dev in zip(net.parts, self.devices)
        ]
        # the seam's noise, drawn once a step for all partitions; without it
        # each partition's step draws its own ids on its own device
        self._seam_noise = None if _noise_fn is None else make_noise(_noise_fn, self.devices[0])
        self._noise_fn = _noise_fn
        self._steps: Dict[str, List[Callable]] = {}
        self._event_plans: Optional[List[EventPlan]] = (
            None if _share is None else _share._event_plans
        )
        self._sync_ells = None
        try:
            self.event_capable = select_step_engine(gather="event", **self._sel).event
        except ValueError:  # fused=True on a partition that cannot fuse
            self.event_capable = False
        if self.event_capable and cfg.gather == "auto":
            self.set_gather("event")  # built here, not inside a later run
        self.set_gather("dense" if cfg.gather == "auto" else cfg.gather)

    def _device_data(self, p: int, opan) -> PartitionDeviceData:
        s, dev = self.stacked, self.devices[p]

        def up(panels):
            return [torch.from_numpy(np.ascontiguousarray(a[p])).to(dev) for a in panels]

        extra = {}
        if opan is not None:
            cl, wl, cr, wr, ll, lr = opan
            weights_local, weights_remote = up(wl), up(wr)
            extra = dict(
                cols_local=checked_cols([a[p] for a in cl], s.n_p, "local", dev),
                weights_local=weights_local,
                row_len_local=up(ll),
                reduce_local=panel_reduce(weights_local),
                cols_remote=checked_cols([a[p] for a in cr], self.n_global, "remote", dev),
                weights_remote=weights_remote,
                row_len_remote=up(lr),
                reduce_remote=panel_reduce(weights_remote),
            )
        weights0 = up(s.weights)
        return PartitionDeviceData(
            n_p=s.n_p,
            vtx_model=torch.from_numpy(s.vtx_model[p]).to(dev),
            vtx_state0=torch.from_numpy(s.vtx_state0[p]).to(dev),
            delays=s.delays,
            cols=checked_cols([c[p] for c in s.cols], self.n_global, "delay-bucket", dev),
            weights0=weights0,
            row_len=row_lengths([v[p] for v in s.valid], dev),
            reduce=panel_reduce(weights0, s.any_plastic),
            identity_rows=tuple(True for _ in s.delays),
            plastic=up(s.plastic) if s.any_plastic else None,
            **extra,
        )

    @property
    def event_plans(self) -> List[EventPlan]:
        """Each partition's touch bitmaps over the ``n_global`` ids, on its
        device, built on first use."""
        if self._event_plans is None:
            s = self.stacked
            cap = event_id_cap(self.n_global, self.cfg.event_cap_frac)
            self._event_plans = [
                EventPlan.build([c[p] for c in s.cols], [v[p] for v in s.valid],
                                self.n_global, cap, self.devices[p])
                for p in range(s.k)
            ]
        return self._event_plans

    def _overlap_ctx(self, p: int) -> Dict[str, Callable]:
        """The partition-geometry closures of the overlap engines
        (``dist_sim.py:424-455`` of the reference)."""
        n_p, n = self.stacked.n_p, self.n_global
        lo, hi = p * n_p, (p + 1) * n_p
        cap = self.index_cap

        def local(spikes):
            if self.exchange != "index":
                return spikes
            # the exchange's truncation past the cap, on the own slice
            return _scatter_ones(compact_spike_ids(spikes, cap)[0], n_p)

        def embed(v):
            out = torch.zeros(n, dtype=v.dtype, device=v.device)
            out[lo:hi] = v
            return out

        def mask_remote(act):
            out = act.clone()
            out[lo:hi] = 0.0
            return out

        return dict(local=local, embed=embed, mask_remote=mask_remote)

    def _make_steps(self, gather: str, *, front: bool = True) -> List[Callable]:
        """The k partitions' step functions of ``gather``; ``front=False``
        takes the chain the step front replaced (``make_core_step``)."""
        choice = select_step_engine(gather=gather, **self._sel)
        return [
            make_core_step(
                registry=self.net.registry,
                models_present=self._models,
                dt=self.dt,
                noise_sigma=self.noise_sigma,
                seed=self.cfg.seed,
                d_ring=self.d_ring,
                dev=dev,
                noise_ids=self._noise_ids[p],
                engine_choice=choice,
                stdp_params=self.stdp_params,
                event_plan=self.event_plans[p] if choice.event else None,
                noise_fn=self._noise_fn,
                overlap_ctx=self._overlap_ctx(p) if choice.overlap != "off" else None,
                front=front,
            )
            for p, dev in enumerate(self.devs)
        ]

    def set_gather(self, gather: str) -> None:
        """Run the next steps with the ``"dense"`` or ``"event"`` gather."""
        if gather not in self._steps:
            self._steps[gather] = self._make_steps(gather)
        self.gather = gather
        self._step = self._steps[gather]

    @property
    def engine_choice(self) -> StepEngineChoice:
        """The step engine the next :meth:`run` takes."""
        return self._step[0].engine_choice

    def init_state(self, t0: int = 0) -> List[Dict]:
        """The list of k per-partition carries at step ``t0``."""
        s = self.stacked
        out = []
        for dev in self.devs:
            zeros = dict(dtype=torch.float32, device=dev.vtx_state0.device)
            out.append(dict(
                t=int(t0),
                vtx_state=dev.vtx_state0.clone(),
                ring=torch.zeros((s.d_ring, s.n_p), **zeros),
                hist=torch.zeros((s.d_ring, s.n_p), dtype=torch.uint8,
                                 device=dev.vtx_state0.device),
                weights=tuple(dev.weights0),
                tr_plus=torch.zeros((s.n_p,), **zeros),
                tr_minus=torch.zeros((s.n_p,), **zeros),
            ))
        return out

    def _exchange(self, spikes: Sequence[torch.Tensor], tr_plus: Sequence[torch.Tensor]):
        """Per partition ``(act, pre_trace)`` on its device, and the
        ``(k,)`` int32 dropped-spike counts (None for the dense exchange)."""
        home = self.devices[0]
        dropped = None
        if self.exchange == "dense":
            act = torch.cat([x.to(home) for x in spikes])
        else:
            n_p, n = self.stacked.n_p, self.n_global
            gids, dropped = [], []
            for p, x in enumerate(spikes):
                ids, drop = compact_spike_ids(x, self.index_cap)
                gids.append(torch.where(ids < n_p, ids + p * n_p, n).to(home))
                dropped.append(drop.to(home))
            act = _scatter_ones(torch.cat(gids), n)
            dropped = torch.stack(dropped)
        # plastic nets also gather the real-valued pre-traces, densely
        pre = torch.cat([x.to(home) for x in tr_plus]) if self.stdp_params else act
        return [(act.to(d), pre.to(d)) for d in self.devices], dropped

    def run(
        self,
        state: List[Dict],
        steps: int,
        *,
        record_raster: Optional[bool] = None,
        record_v: Optional[bool] = None,
    ) -> Tuple[List[Dict], Dict]:
        """Advance ``steps`` steps; returns ``(state', outs)`` with ``outs``
        on the first device: ``spike_count`` and ``overflow`` ``(steps, k)``
        int32, and, when recorded, ``raster`` ``(steps, k, n_p)`` uint8 and
        ``v_mean`` ``(steps, k)`` f32.  The caller's state is not
        changed."""
        if record_raster is None:
            record_raster = self.cfg.record_raster
        if record_v is None:
            record_v = self.cfg.record_v
        s = self.stacked
        plastic = s.any_plastic
        carries = []
        for c, dev in zip(state, self.devs):
            carry = dict(c)
            for key in ("vtx_state", "ring", "hist", "tr_plus", "tr_minus"):
                carry[key] = c[key].clone()
            if plastic:
                carry["weights"] = tuple(w.clone() for w in c["weights"])
            carry["_reduce"] = state_reduce(dev, carry["weights"])
            carry["t"] = int(c["t"])
            carries.append(carry)
        home = self.devices[0]
        on = dict(device=home)
        outs = dict(
            spike_count=torch.empty((steps, s.k), dtype=torch.int32, **on),
            overflow=torch.zeros((steps, s.k), dtype=torch.int32, **on),
        )
        if record_raster:
            outs["raster"] = torch.empty((steps, s.k, s.n_p), dtype=torch.uint8, **on)
        if record_v:
            outs["v_mean"] = torch.empty((steps, s.k), dtype=torch.float32, **on)
        fns = self._step
        choice = fns[0].engine_choice
        has_post = choice.split or not choice.fused
        for j in range(steps):
            noise_g = None if self._seam_noise is None else self._seam_noise(carries[0]["t"])
            halves = [f.pre(c, noise_g) for f, c in zip(fns, carries)]
            spikes = [h[0] for h in halves]
            if has_post:
                delivered, dropped = self._exchange(spikes, [h[1] for h in halves])
                if dropped is not None:
                    outs["overflow"][j] = dropped
            else:
                delivered = [(None, None)] * s.k
            for f, c, x, (act, pre) in zip(fns, carries, spikes, delivered):
                f.post(c, x, act, pre)
            sp = torch.stack([x.to(home) for x in spikes])
            outs["spike_count"][j] = sp.sum(dim=1)
            if record_raster:
                outs["raster"][j] = sp
            if record_v:
                outs["v_mean"][j] = torch.stack(
                    [c["vtx_state"][:, LIF_V].to(home).mean() for c in carries]
                )
        for f, c in zip(fns, carries):
            f.pending_flush(c)
            del c["_reduce"]
        return carries, outs

    # -- dCSR sync (simulation state -> serializable network) -------------
    def state_to_dcsr(self, state: List[Dict]) -> None:
        """Write the partitions' state back into the dCSR partitions in
        place (weights via each partition's ELL ``edge_index``).  The ELLs
        are built once and kept: they depend only on topology."""
        s = self.stacked
        if self._sync_ells is None:
            self._sync_ells = [
                build_delay_ell(part, self.net.n, align_k=self.cfg.align_k,
                                align_rows=self.cfg.align_rows)
                for part in self.net.parts
            ]
        for part, ell, carry in zip(self.net.parts, self._sync_ells, state):
            part.vtx_state = carry["vtx_state"].cpu().numpy()[: part.n]
            new_w = []
            for b in ell.buckets:
                R, K = b.weights.shape
                new_w.append(carry["weights"][s.delays.index(b.delay)][:R, :K].cpu().numpy())
            ell.update_bucket_weights(new_w)
            ell.scatter_weights_back(part)

    def runtime_state(self, state: List[Dict]) -> Dict[int, Dict[str, np.ndarray]]:
        """In-flight runtime arrays (ring/hist/traces) keyed per partition.
        On the CPU they are views of the carries: a snapshot copies them."""
        return stack_runtime(state, self.stacked.k)

    def load_runtime(
        self, state: List[Dict], sim_state: Dict[int, Dict[str, np.ndarray]]
    ) -> List[Dict]:
        """``state`` with a snapshot's runtime arrays of the same k, each
        partition's on that partition's device; a key that some partition
        lacks is left as it was."""
        if not sim_state:
            return state
        parts = [sim_state.get(p, {}) for p in range(self.stacked.k)]
        keys = set(RUNTIME_KEYS).intersection(*(set(p) for p in parts))
        return [
            load_runtime_arrays(carry, {key: part[key] for key in RUNTIME_KEYS if key in keys},
                                f"DistSimulator.load_runtime, partition {p}")
            for p, (carry, part) in enumerate(zip(state, parts))
        ]
