"""Decoder-only LM assembling the block zoo (attn / local_attn / rglru /
mlstm / slstm, dense or MoE FFN), the counterpart of
``repro/models/transformer.py``.

One module per layer in a ``ModuleList``, in layer order.  The reference
stacks the ``L // P`` full groups of its block pattern (period P) under
``jax.lax.scan`` and runs the ``L % P`` remainder layers after them; that
is a tracing device, so here layer ``g * P + j`` is the reference's group
``g``, position ``j``, and the remainder follows (``convert`` unstacks a
reference tree the same way).  With ``cfg.remat``, a forward that builds a
graph (no cache, grad enabled) runs each full group of ``P`` layers under
``torch.utils.checkpoint`` (non-reentrant), the reference's
``jax.checkpoint`` around ``run_group``: the group's activations are
recomputed in the backward instead of kept.  The cache is a list with one
dict per layer: ``k``/``v`` for attention (a ring of ``min(window, seq_len)`` slots for
local attention), ``h``/``conv`` for RG-LRU, ``C``/``n``/``m``/``conv`` for
mLSTM, ``c``/``n``/``m``/``h`` for sLSTM; every entry is written in place.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..sharding.policy import constrain
from . import layers as L
from .moe import MoE
from .rglru import RGLRU, rglru_init_state
from .xlstm import MLSTM, SLSTM, mlstm_init_state, slstm_init_state

MIXER_HAS_MLP = {"attn": True, "local_attn": True, "rglru": True,
                 "mlstm": False, "slstm": False}


class Block(nn.Module):
    """``ln1``, ``mixer`` and, where the block type has one, ``ln2`` and
    ``mlp`` (a dense MLP or the MoE)."""

    def __init__(self, cfg, btype: str, dtype, device, generator):
        super().__init__()
        self.cfg = cfg
        self.btype = btype
        self.ln1 = L.Norm(cfg.norm, cfg.d_model, dtype, device)
        if btype in ("attn", "local_attn"):
            self.mixer = L.Attention(cfg, dtype, device, generator)
        elif btype == "rglru":
            self.mixer = RGLRU(cfg, dtype, device, generator)
        elif btype == "mlstm":
            self.mixer = MLSTM(cfg, dtype, device, generator)
        elif btype == "slstm":
            self.mixer = SLSTM(cfg, dtype, device, generator)
        else:
            raise ValueError(btype)
        if MIXER_HAS_MLP[btype] and cfg.mlp != "none":
            self.ln2 = L.Norm(cfg.norm, cfg.d_model, dtype, device)
            self.mlp = MoE(cfg, dtype, device, generator) if cfg.moe \
                else L.MLP(cfg, dtype, device, generator)
        else:
            self.ln2 = self.mlp = None

    def forward(self, x, *, positions, cache=None, cache_pos=None,
                prefix_len=0) -> Tuple[torch.Tensor, Optional[Dict], Dict]:
        cfg = self.cfg
        aux: Dict = {}
        h = self.ln1(x)
        decode = cache_pos is not None
        if self.btype in ("attn", "local_attn"):
            out, cache = self.mixer(
                h, positions=positions, causal=True,
                window=cfg.window if self.btype == "local_attn" else 0,
                prefix_len=prefix_len, cache=cache, cache_pos=cache_pos,
            )
        else:
            out, cache = self.mixer(h, state=cache, decode=decode)
        x = x + out
        if self.mlp is not None:
            h2 = self.ln2(x)
            if cfg.moe:
                m, aux = self.mlp(h2)
            else:
                m = self.mlp(h2)
            x = x + m
        return constrain(x, "btd"), cache, aux


def block_cache_init(cfg, btype: str, batch: int, seq_len: int, dtype, device) -> Dict:
    KV, hd = cfg.n_kv_heads, cfg.hd
    if btype in ("attn", "local_attn"):
        slots = seq_len if btype == "attn" else min(cfg.window or seq_len, seq_len)
        return dict(k=torch.zeros((batch, slots, KV, hd), dtype=dtype, device=device),
                    v=torch.zeros((batch, slots, KV, hd), dtype=dtype, device=device))
    if btype == "rglru":
        return rglru_init_state(cfg, batch, dtype, device)
    if btype == "mlstm":
        return mlstm_init_state(cfg, batch, dtype, device)
    if btype == "slstm":
        return slstm_init_state(cfg, batch, dtype, device)
    raise ValueError(btype)


class DecoderLM(nn.Module):
    """cfg-driven decoder LM: ``emb`` (+ ``out_head``), ``layers``,
    ``ln_f``.  Parameters live on ``device``, drawn from ``generator`` (a
    ``torch.Generator`` on that device)."""

    def __init__(self, cfg, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        dt = L.dtype_of(cfg.param_dtype)
        self.emb = L.Embed(cfg, dt, device, generator)
        self.ln_f = L.Norm(cfg.norm, cfg.d_model, dt, device)
        self.layers = nn.ModuleList(
            Block(cfg, cfg.block_at(i), dt, device, generator) for i in range(cfg.n_layers)
        )

    @property
    def device(self) -> torch.device:
        return self.emb.embed.device

    def _run_group(self, x, g0: int, positions, prefix_len):
        """Layers ``g0 .. g0 + P - 1`` without a cache (the reference's
        ``run_group``): ``(x, the group's aux summed)``."""
        auxs = L.zeros_aux(self.cfg, x.device)
        for layer in self.layers[g0:g0 + self.cfg.pattern_period]:
            x, _, aux = layer(x, positions=positions, prefix_len=prefix_len)
            for key in auxs:
                auxs[key] = auxs[key] + aux.get(key, 0.0)
        return x, auxs

    def init_cache(self, batch: int, seq_len: int) -> List[Dict[str, torch.Tensor]]:
        cdt = L.dtype_of(self.cfg.compute_dtype)
        return [block_cache_init(self.cfg, layer.btype, batch, seq_len, cdt, self.device)
                for layer in self.layers]

    def forward(
        self,
        tokens: torch.Tensor,  # (B, S) int
        *,
        img_embed: Optional[torch.Tensor] = None,  # (B, n_img, d)
        cache: Optional[List[Dict]] = None,
        cache_pos=None,
        positions: Optional[torch.Tensor] = None,
        logits_slice: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Optional[List[Dict]], Dict[str, Any]]:
        """Returns ``(logits, cache, aux)``: the cache is ``cache`` itself,
        updated in place (None without one); ``cache_pos``, a decode step's
        position, a 0-d device tensor."""
        cfg = self.cfg
        x = self.emb.lookup(tokens)
        if img_embed is not None and cfg.n_img_tokens:
            x = torch.cat([img_embed.to(x.dtype), x], dim=1)
        prefix_len = cfg.n_img_tokens if img_embed is not None else 0
        B, S, _ = x.shape
        dev = x.device
        if positions is None:
            ones = torch.ones((B, 1), dtype=torch.int32, device=dev)
            if cache_pos is not None:
                positions = cache_pos.reshape(1, 1) * ones
            else:
                positions = torch.arange(S, dtype=torch.int32, device=dev)[None, :] * ones
        x = constrain(x, "btd")
        aux_total = L.zeros_aux(cfg, dev)
        P = cfg.pattern_period
        n_remat = 0
        if cfg.remat and cache is None and torch.is_grad_enabled():
            n_remat = (cfg.n_layers // P) * P if cfg.layer_stack == "scan" else 0
        for g0 in range(0, n_remat, P):
            x, aux = checkpoint(self._run_group, x, g0, positions, prefix_len,
                                use_reentrant=False)
            for key in aux_total:
                aux_total[key] = aux_total[key] + aux[key]
        for i in range(n_remat, len(self.layers)):
            x, _, aux = self.layers[i](x, positions=positions,
                                       cache=cache[i] if cache is not None else None,
                                       cache_pos=cache_pos, prefix_len=prefix_len)
            for key in aux_total:
                aux_total[key] = aux_total[key] + aux.get(key, 0.0)
        x = self.ln_f(x)
        if logits_slice is not None:
            x = x[:, -logits_slice:]
        return self.emb.logits(x), cache, aux_total
