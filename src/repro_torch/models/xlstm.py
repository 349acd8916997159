"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory with a
recurrent hidden-to-hidden map), exponential gating with max-stabilizers;
the counterpart of ``repro/models/xlstm.py``.

  mLSTM block: up-proj x2 (d -> 2d) -> [conv + swish -> q, k | v] ->
               mLSTM cell -> group-norm -> gate by swish(z) -> down-proj
  sLSTM block: sLSTM cell (block-diagonal recurrent R per head) ->
               group-norm -> GeGLU up/down (4/3 factor)

Both cells run as a loop over time (the recurrent form); the mLSTM also
has the chunkwise-parallel form, taken when ``cfg.mlstm_chunk`` divides
``S`` and ``S > 1``.  The stabilizer ``m`` starts at ``-1e30``; the cells
run in fp32; a prefill's per-step outputs are cast to ``cfg.state_dtype``;
the cached ``C``, ``n`` (and sLSTM's ``c``, ``n``, ``h``) and ``conv`` are
stored in the compute dtype and ``m`` in fp32, each written in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..sharding.policy import assign_, constrain
from .layers import NEG, Dense, Norm, dtype_of, gelu, softplus, trunc_normal
from .rglru import causal_conv


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_cell(q, k, v, i_pre, f_pre, state):
    """One step.  q/k/v: (B, nh, hd); i_pre/f_pre: (B, nh); state: (C (B,
    nh, hd, hd), n (B, nh, hd), m (B, nh))."""
    C, n, m = state
    log_f = -softplus(-f_pre)  # log sigmoid(f)
    m_new = torch.maximum(log_f + m, i_pre)
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(log_f + m - m_new)
    C_new = f_s[..., None, None] * C + i_s[..., None, None] * (v[..., :, None] * k[..., None, :])
    n_new = f_s[..., None] * n + i_s[..., None] * k
    num = torch.einsum("bhij,bhj->bhi", C_new, q)
    den = torch.maximum(torch.abs(torch.einsum("bhj,bhj->bh", n_new, q)), torch.exp(-m_new))
    return (C_new, n_new, m_new), num / den[..., None]


def mlstm_chunked(q, k, v, i_pre, f_pre, T):
    """Chunkwise-parallel mLSTM: the sequential cell's math, each chunk of
    length T one batch of matmuls, the matrix memory carried per chunk.
    q/k/v: (B, nh, S, hd); i_pre/f_pre: (B, nh, S).  Returns (hs (B, nh, S,
    hd), (C, n, m)), the final stabilized state."""
    B, nh, S, hd = q.shape
    assert S % T == 0
    nc = S // T
    qs = q.reshape(B, nh, nc, T, hd).transpose(1, 2)  # (B, nc, nh, T, hd)
    ks = k.reshape(B, nh, nc, T, hd).transpose(1, 2)
    vs = v.reshape(B, nh, nc, T, hd).transpose(1, 2)
    ip = i_pre.reshape(B, nh, nc, T).transpose(1, 2)  # (B, nc, nh, T)
    log_fs = (-softplus(-f_pre)).reshape(B, nh, nc, T).transpose(1, 2)
    tri = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    C = torch.zeros((B, nh, hd, hd), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, nh, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, nh), NEG, dtype=torch.float32, device=q.device)
    hs = []
    for c in range(nc):
        qc, kc, vc, ic, lfc = qs[:, c], ks[:, c], vs[:, c], ip[:, c], log_fs[:, c]
        Fc = torch.cumsum(lfc, dim=-1)  # (B, nh, T)
        A = Fc[..., :, None] - Fc[..., None, :] + ic[..., None, :]  # F_t - F_s + log i_s
        A = torch.where(tri, A, -torch.inf)
        mm = torch.maximum(m[..., None] + Fc, A.amax(dim=-1))  # (B, nh, T)
        D = torch.exp(A - mm[..., None])
        scores = torch.einsum("bhtd,bhsd->bhts", qc, kc)
        intra_num = torch.einsum("bhts,bhsd->bhtd", D * scores, vc)
        intra_den = torch.einsum("bhts,bhts->bht", D, scores)
        carry_scale = torch.exp(m[..., None] + Fc - mm)
        inter_num = torch.einsum("bhtd,bhed->bhte", qc, C)
        inter_den = torch.einsum("bhtd,bhd->bht", qc, n)
        num = intra_num + carry_scale[..., None] * inter_num
        den = torch.maximum(torch.abs(intra_den + carry_scale * inter_den), torch.exp(-mm))
        hs.append(num / den[..., None])
        mT = mm[..., -1]
        wts = torch.exp(ic + (Fc[..., -1:] - Fc) - mT[..., None])
        decay = torch.exp(Fc[..., -1] + m - mT)
        C = decay[..., None, None] * C + torch.einsum("bhs,bhsd,bhse->bhde", wts, vc, kc)
        n = decay[..., None] * n + torch.einsum("bhs,bhsd->bhd", wts, kc)
        m = mT
    hs = torch.stack(hs, dim=1).transpose(1, 2).reshape(B, nh, S, hd)
    return hs, (C, n, m)


class MLSTM(nn.Module):
    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        di, nh = 2 * d, cfg.n_heads
        mk = lambda d_in, d_out, **kw: Dense(d_in, d_out, dtype, device, generator, **kw)
        self.w_up = mk(d, di)
        self.w_z = mk(d, di)
        self.conv_w = nn.Parameter(trunc_normal((4, di), 0.5, dtype, device, generator))
        self.wq = mk(di, di)
        self.wk = mk(di, di)
        self.wv = mk(di, di)
        self.w_if = mk(di, 2 * nh)  # i, f gate pre-activations
        self.gn = Norm("rmsnorm", di, dtype, device)
        self.w_down = mk(di, d, scale=di ** -0.5)

    def forward(self, x, *, state: Optional[Dict] = None, decode: bool = False):
        """x: (B, S, d); state: dict(C, n, m, conv), updated in place."""
        cfg = self.cfg
        cdt = dtype_of(cfg.compute_dtype)
        B, S, d = x.shape
        nh, di = cfg.n_heads, 2 * d
        hd = di // nh
        u = self.w_up(x, cdt)
        z = self.w_z(x, cdt)
        c, new_conv = causal_conv(u, self.conv_w, state["conv"] if state is not None else None)
        c = F.silu(c)
        q = self.wq(c, cdt).reshape(B, S, nh, hd)
        k = self.wk(c, cdt).reshape(B, S, nh, hd) * (hd ** -0.5)
        v = self.wv(u, cdt).reshape(B, S, nh, hd)
        g = self.w_if(u, cdt).float().reshape(B, S, 2, nh)
        i_pre, f_pre = g[:, :, 0], g[:, :, 1]

        if state is not None and decode:
            st = (state["C"].float(), state["n"].float(), state["m"].float())
            st, h = mlstm_cell(q[:, 0].float(), k[:, 0].float(), v[:, 0].float(),
                               i_pre[:, 0], f_pre[:, 0], st)
            hs = h[:, None]
        elif cfg.mlstm_chunk and S % cfg.mlstm_chunk == 0 and S > 1:
            hs_h, st = mlstm_chunked(q.float().transpose(1, 2), k.float().transpose(1, 2),
                                     v.float().transpose(1, 2), i_pre.transpose(1, 2),
                                     f_pre.transpose(1, 2), cfg.mlstm_chunk)
            hs = hs_h.transpose(1, 2)  # (B, S, nh, hd)
        else:
            st = (torch.zeros((B, nh, hd, hd), device=x.device),
                  torch.zeros((B, nh, hd), device=x.device),
                  torch.full((B, nh), NEG, device=x.device))
            ydt = dtype_of(cfg.state_dtype)
            qf, kf, vf = q.float(), k.float(), v.float()
            ys = []
            for t in range(S):
                st, h = mlstm_cell(qf[:, t], kf[:, t], vf[:, t], i_pre[:, t], f_pre[:, t], st)
                ys.append(h.to(ydt))
            hs = torch.stack(ys, dim=1)  # (B, S, nh, hd)
        if state is not None:
            for key, val in zip(("C", "n", "m"), st):
                assign_(state[key], val)
            assign_(state["conv"], new_conv)
        hflat = self.gn(hs.reshape(B, -1, di).to(cdt))
        return constrain(self.w_down(hflat * F.silu(z), cdt), "btd"), state


def mlstm_init_state(cfg, batch, dtype, device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    di, nh = 2 * d, cfg.n_heads
    hd = di // nh
    return dict(
        C=torch.zeros((batch, nh, hd, hd), dtype=dtype, device=device),
        n=torch.zeros((batch, nh, hd), dtype=dtype, device=device),
        m=torch.full((batch, nh), NEG, dtype=torch.float32, device=device),
        conv=torch.zeros((batch, 3, di), dtype=dtype, device=device),
    )


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_cell(w_pre, r_w, state):
    """w_pre: (B, nh, 4*hd) input pre-activations; r_w: (nh, hd, 4*hd);
    state: (c, n, m, h) each (B, nh, hd)."""
    c, n, m, h = state
    pre = w_pre + torch.einsum("bhi,hij->bhj", h, r_w)
    z_p, i_p, f_p, o_p = torch.chunk(pre, 4, dim=-1)
    z = torch.tanh(z_p)
    o = torch.sigmoid(o_p)
    log_f = -softplus(-f_p)
    m_new = torch.maximum(log_f + m, i_p)
    i_s = torch.exp(i_p - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * z
    n_new = f_s * n + i_s
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, m_new, h_new), h_new


class SLSTM(nn.Module):
    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        self.cfg = cfg
        d, nh = cfg.d_model, cfg.n_heads
        hd = d // nh
        self.w_gates = Dense(d, 4 * d, dtype, device, generator)  # z, i, f, o
        self.r_gates = nn.Parameter(trunc_normal((nh, hd, 4 * hd), hd ** -0.5, dtype, device,
                                                 generator))
        self.gn = Norm("rmsnorm", d, dtype, device)
        self.w_up = Dense(d, 2 * (4 * d // 3), dtype, device, generator)
        self.w_down = Dense(4 * d // 3, d, dtype, device, generator,
                            scale=(4 * d // 3) ** -0.5)

    def forward(self, x, *, state: Optional[Dict] = None,
                decode: bool = False) -> Tuple[torch.Tensor, Optional[Dict]]:
        cfg = self.cfg
        cdt = dtype_of(cfg.compute_dtype)
        B, S, d = x.shape
        nh = cfg.n_heads
        hd = d // nh
        w_pre = self.w_gates(x, cdt).float().reshape(B, S, nh, 4 * hd)
        r_w = self.r_gates.float()
        if state is not None and decode:
            st = tuple(state[key].float() for key in "cnmh")
            st, h = slstm_cell(w_pre[:, 0], r_w, st)
            hs = h[:, None]
        else:
            z0 = torch.zeros((B, nh, hd), device=x.device)
            st = (z0, z0, torch.full((B, nh, hd), NEG, device=x.device), z0)
            ydt = dtype_of(cfg.state_dtype)
            ys = []
            for t in range(S):
                st, h = slstm_cell(w_pre[:, t], r_w, st)
                ys.append(h.to(ydt))
            hs = torch.stack(ys, dim=1)
        if state is not None:
            for key, val in zip("cnmh", st):
                assign_(state[key], val)
        hflat = self.gn(hs.reshape(B, -1, d).to(cdt))
        a, b = torch.chunk(self.w_up(hflat, cdt), 2, dim=-1)
        return constrain(self.w_down(gelu(a) * b, cdt), "btd"), state


def slstm_init_state(cfg, batch, dtype, device) -> Dict[str, torch.Tensor]:
    d, nh = cfg.d_model, cfg.n_heads
    shape = (batch, nh, d // nh)
    return dict(c=torch.zeros(shape, dtype=dtype, device=device),
                n=torch.zeros(shape, dtype=dtype, device=device),
                m=torch.full(shape, NEG, dtype=torch.float32, device=device),
                h=torch.zeros(shape, dtype=dtype, device=device))
