"""Whisper-style encoder-decoder backbone, the counterpart of
``repro/models/encdec.py``.  The conv/mel frontend is the reference's STUB:
the encoder consumes precomputed frame embeddings ``(B, S_enc, d_model)``.

Encoder: learned positions + bidirectional self-attention layers.
Decoder: learned positions (no rope) + causal self-attention, cross-attention
and MLP layers.  The cache holds, stacked over the decoder's layers, the
self-attention KV (``self_k``/``self_v``, one slot a position) and the
cross-attention KV of the encoder output (``cross_k``/``cross_v``), written
at prefill and reused untouched by every decode step (``k_valid`` the
encoder length); all of it is written in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..sharding.policy import constrain
from . import layers as L


class EncLayer(nn.Module):
    def __init__(self, cfg, dt, device, generator):
        super().__init__()
        self.ln1 = L.Norm(cfg.norm, cfg.d_model, dt, device)
        self.attn = L.Attention(cfg, dt, device, generator)
        self.ln2 = L.Norm(cfg.norm, cfg.d_model, dt, device)
        self.mlp = L.MLP(cfg, dt, device, generator)


class DecLayer(nn.Module):
    def __init__(self, cfg, dt, device, generator):
        super().__init__()
        self.ln1 = L.Norm(cfg.norm, cfg.d_model, dt, device)
        self.self_attn = L.Attention(cfg, dt, device, generator)
        self.ln_x = L.Norm(cfg.norm, cfg.d_model, dt, device)
        self.cross_attn = L.Attention(cfg, dt, device, generator)
        self.ln2 = L.Norm(cfg.norm, cfg.d_model, dt, device)
        self.mlp = L.MLP(cfg, dt, device, generator)


class EncDecLM(nn.Module):
    """``emb``, ``enc_pos``, ``dec_pos`` (learned ``(max_seq, d)`` tables),
    ``enc_layers``, ``dec_layers``, ``enc_ln_f`` and ``ln_f``."""

    def __init__(self, cfg, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        dt = L.dtype_of(cfg.param_dtype)
        self.enc_layers = nn.ModuleList(
            EncLayer(cfg, dt, device, generator) for _ in range(cfg.enc_layers))
        self.dec_layers = nn.ModuleList(
            DecLayer(cfg, dt, device, generator) for _ in range(cfg.n_layers))
        self.emb = L.Embed(cfg, dt, device, generator)
        pos = lambda: nn.Parameter(
            L.trunc_normal((cfg.max_seq, cfg.d_model), 0.02, dt, device, generator))
        self.enc_pos = pos()
        self.dec_pos = pos()
        self.enc_ln_f = L.Norm(cfg.norm, cfg.d_model, dt, device)
        self.ln_f = L.Norm(cfg.norm, cfg.d_model, dt, device)

    @property
    def device(self) -> torch.device:
        return self.emb.embed.device

    # -- encoder -----------------------------------------------------------
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, S_enc, d), the stub frontend's output."""
        cfg = self.cfg
        cdt = L.dtype_of(cfg.compute_dtype)
        S = frames.shape[1]
        x = constrain(frames.to(cdt) + self.enc_pos[:S].to(cdt), "btd")
        pos = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
        for lp in self.enc_layers:
            out, _ = lp.attn(lp.ln1(x), positions=pos, causal=False)
            x = x + out
            x = constrain(x + lp.mlp(lp.ln2(x)), "btd")
        return self.enc_ln_f(x)

    # -- caches --------------------------------------------------------------
    def init_cache(self, batch: int, seq_len: int, enc_len: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        cdt = L.dtype_of(cfg.compute_dtype)
        z = lambda s: torch.zeros((cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.hd),
                                  dtype=cdt, device=self.device)
        return dict(self_k=z(seq_len), self_v=z(seq_len), cross_k=z(enc_len),
                    cross_v=z(enc_len))

    # -- decoder ---------------------------------------------------------------
    def decode(self, tokens: torch.Tensor, *, enc_out: Optional[torch.Tensor] = None,
               cache: Optional[Dict] = None,
               cache_pos=None) -> Tuple[torch.Tensor, Optional[Dict], Dict]:
        """``enc_out`` is needed at prefill (and without a cache); a decode
        step (``cache_pos``, a 0-d device tensor) reads the cached cross
        KV."""
        cfg = self.cfg
        cdt = L.dtype_of(cfg.compute_dtype)
        B, S = tokens.shape
        x = self.emb.lookup(tokens)
        dev = x.device
        if cache_pos is None:
            x = x + self.dec_pos[:S].to(cdt)
            positions = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
        else:
            # the reference's dynamic_slice clamps the start into the table
            row = torch.clamp(cache_pos, 0, cfg.max_seq - 1).reshape(1).long()
            x = x + self.dec_pos.index_select(0, row).to(cdt)
            positions = cache_pos.reshape(1, 1) * torch.ones((B, 1), dtype=torch.int32,
                                                             device=dev)
        x = constrain(x, "btd")
        for i, lp in enumerate(self.dec_layers):
            c_self = c_cross = None
            if cache is not None:
                c_self = dict(k=cache["self_k"][i], v=cache["self_v"][i])
                c_cross = dict(k=cache["cross_k"][i], v=cache["cross_v"][i])
            out, _ = lp.self_attn(lp.ln1(x), positions=positions, causal=True, cache=c_self,
                                  cache_pos=cache_pos)
            x = x + out
            out, _ = lp.cross_attn(lp.ln_x(x), positions=positions, causal=False,
                                   cache=c_cross, cache_pos=cache_pos, kv_source=enc_out,
                                   cross=True)
            x = x + out
            x = constrain(x + lp.mlp(lp.ln2(x)), "btd")
        return self.emb.logits(self.ln_f(x)), cache, {}

    def forward(self, tokens, *, frames=None, enc_out=None, cache=None, cache_pos=None, **_):
        """The train/serve entry: a prefill (or a cache-free forward) passes
        ``frames`` and the encoder runs; a decode step passes the cache."""
        if enc_out is None and frames is not None:
            enc_out = self.encode(frames)
        return self.decode(tokens, enc_out=enc_out, cache=cache, cache_pos=cache_pos)
