"""RG-LRU recurrent block (RecurrentGemma / Griffin), the counterpart of
``repro/models/rglru.py``.

Two linear branches from the residual stream: branch 1 goes through a
width-4 causal depthwise conv and the Real-Gated Linear Recurrent Unit,
branch 2 gates the output through GeLU; a final linear projects back.

    r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)            (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill evaluates the linear recurrence with a log-depth scan (a doubling
scan over S); the reference's ``jax.lax.associative_scan`` associates the
products in another tree, so the two agree to f32 rounding, not bit for
bit.  Decode is one elementwise update carrying ``h``.  The state is
``h (B, d)`` and ``conv (B, 3, d)``, both stored in the compute dtype and
written in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..sharding.policy import assign_, constrain
from .layers import Dense, dtype_of, gelu, softplus, trunc_normal

_C = 8.0
_CONV_W = 4


def causal_conv(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor]):
    """Depthwise causal conv of width ``W = len(w)``.  state: (B, W-1, d),
    the trailing inputs of the previous call (decode carries it).  Returns
    ``(out, new_state)``."""
    B, S, d = x.shape
    W = w.shape[0]
    pad = torch.zeros((B, W - 1, d), dtype=x.dtype, device=x.device) if state is None \
        else state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+W-1, d)
    out = sum(xp[:, i: i + S] * w[i].to(x.dtype) for i in range(W))
    return out, xp[:, -(W - 1):]


def scan_recurrence(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` over axis 1 (h_{-1} = 0): a doubling
    scan of the combine ``(a1, b1), (a2, b2) -> (a1 * a2, b1 * a2 + b2)``."""
    S = a.shape[1]
    off = 1
    while off < S:
        b = torch.cat([b[:, :off], b[:, :-off] * a[:, off:] + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return b


class RGLRU(nn.Module):
    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        # Lambda so that a ~ Uniform(0.9, 0.999) at r = 1
        u = torch.empty(d, dtype=torch.float32, device=device).uniform_(
            0.9, 0.999, generator=generator)
        lam = torch.log(torch.expm1(-torch.log(u) / _C))
        self.w_x = Dense(d, d, dtype, device, generator)
        self.w_gate_br = Dense(d, d, dtype, device, generator)
        self.conv_w = nn.Parameter(trunc_normal((_CONV_W, d), _CONV_W ** -0.5, dtype, device,
                                                generator))
        self.w_rec_gates = Dense(d, 2 * d, dtype, device, generator)  # r and i gates
        self.a_param = nn.Parameter(lam)
        self.w_out = Dense(d, d, dtype, device, generator, scale=d ** -0.5)

    def forward(self, x, *, state: Optional[Dict] = None,
                decode: bool = False) -> Tuple[torch.Tensor, Optional[Dict]]:
        """x: (B, S, d); the state, when given, is updated in place."""
        cdt = dtype_of(self.cfg.compute_dtype)
        branch = self.w_x(x, cdt)
        gate_br = self.w_gate_br(x, cdt)
        u, new_conv = causal_conv(branch, self.conv_w,
                                  state["conv"] if state is not None else None)
        gates = self.w_rec_gates(u, cdt).float()
        r, i = torch.chunk(torch.sigmoid(gates), 2, dim=-1)
        log_a = (-_C * softplus(self.a_param)) * r  # (B, S, d) fp32
        a = torch.exp(log_a)
        gated_x = i * u.float()
        b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * gated_x
        if decode:
            h = a[:, 0] * state["h"].float() + b[:, 0]
            hs = h[:, None, :]
        else:
            hs = scan_recurrence(a, b)
            h = hs[:, -1]
        if state is not None:
            assign_(state["h"], h)
            assign_(state["conv"], new_conv)
        out = hs.to(cdt) * gelu(gate_br)
        return constrain(self.w_out(out, cdt), "btd"), state


def rglru_init_state(cfg, batch, dtype, device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    return dict(h=torch.zeros((batch, d), dtype=dtype, device=device),
                conv=torch.zeros((batch, _CONV_W - 1, d), dtype=dtype, device=device))
