"""Plain torch versions of the port's kernels (the correctness contract).

Counterpart of ``repro/kernels/ref.py``: each function is the mathematical
definition its CUDA kernel must match, written with the reference's
operation order.  The kernel wrappers take these for CPU tensors, the CPU
tests hold them against the JAX oracles, and ``chip_smoke.py`` holds the
kernels against them on the card.  ``alif_step_ref`` and
``izhikevich_step_ref`` have no kernel, as in the reference, where they run
as jnp outside any Pallas kernel.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import torch

Tensor = torch.Tensor


@functools.lru_cache(maxsize=64)
def lif_constants(dt: float, tau_m: float, t_ref: float) -> Tuple[float, float]:
    """``(decay, ref_steps)``: ``exp(-dt/tau_m)`` rounded to f32 and
    ``round(t_ref/dt)``, computed once on the host (``ref.py:48,53`` of the
    reference) and handed to the plain version and the kernels alike."""
    decay = torch.exp(torch.tensor(-dt / tau_m, dtype=torch.float32)).item()
    return decay, float(round(t_ref / dt))


def spike_gather_ref(
    activity: Tensor,  # (n,) global activity (spikes as 0/1 floats)
    cols: Tensor,  # (R, K) int32 global source ids (0 on padding)
    weights: Tensor,  # (R, K) weights (0 on padding)
) -> Tensor:  # (R,)
    """currents[r] = sum_k weights[r,k] * activity[cols[r,k]], in f32.

    Padding slots carry weight 0, so no mask is needed (the layout
    invariant of ``core/ell.py``)."""
    vals = activity.index_select(0, cols.reshape(-1)).reshape(cols.shape)
    return torch.sum(weights.float() * vals.float(), dim=-1)


def lif_step_ref(
    v: Tensor,  # (R,) membrane potential
    refrac: Tensor,  # (R,) remaining refractory steps (float, >= 0)
    i_syn: Tensor,  # (R,) synaptic current this step
    *,
    dt: float,
    tau_m: float,
    v_rest: float,
    v_reset: float,
    v_thresh: float,
    t_ref: float,
    r_m: float,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Leaky integrate-and-fire, exact exponential-Euler update; returns
    ``(v', refrac', spike)``.  During refractoriness the membrane is clamped
    to ``v_reset`` and input is discarded; the counter then decrements."""
    decay, ref_steps = lif_constants(dt, tau_m, t_ref)
    active = refrac <= 0
    v_int = v_rest + (v - v_rest) * decay + r_m * i_syn * (1.0 - decay)
    v_new = torch.where(active, v_int, torch.full_like(v, v_reset))
    spike = (v_new >= v_thresh) & active
    refrac_new = torch.where(
        spike, torch.full_like(refrac, ref_steps),
        torch.clamp_min(refrac - 1, 0.0),
    )
    v_out = torch.where(spike, torch.full_like(v, v_reset), v_new)
    return v_out, refrac_new, spike.to(v.dtype)


def alif_step_ref(
    v, refrac, adapt, i_syn, *, dt, tau_m, v_rest, v_reset, v_thresh,
    t_ref, r_m, tau_adapt, beta,
):
    """Adaptive LIF: threshold rises by beta per spike, decays with
    tau_adapt.  Returns (v', refrac', adapt', spike)."""
    decay, ref_steps = lif_constants(dt, tau_m, t_ref)
    a_decay = torch.exp(torch.tensor(-dt / tau_adapt, dtype=v.dtype)).item()
    active = refrac <= 0
    v_int = v_rest + (v - v_rest) * decay + r_m * i_syn * (1.0 - decay)
    v_new = torch.where(active, v_int, torch.full_like(v, v_reset))
    thresh = v_thresh + adapt
    spike = (v_new >= thresh) & active
    refrac_new = torch.where(
        spike, torch.full_like(refrac, ref_steps),
        torch.clamp_min(refrac - 1, 0.0),
    )
    adapt_new = adapt * a_decay + beta * spike.to(v.dtype)
    v_out = torch.where(spike, torch.full_like(v, v_reset), v_new)
    return v_out, refrac_new, adapt_new, spike.to(v.dtype)


def izhikevich_step_ref(v, u, i_syn, *, dt, a, b, c, d):
    """Izhikevich (2003) two-variable model, forward Euler.
    Returns (v', u', spike)."""
    spike = v >= 30.0
    v0 = torch.where(spike, torch.full_like(v, c), v)
    u0 = torch.where(spike, u + d, u)
    dv = 0.04 * v0 * v0 + 5.0 * v0 + 140.0 - u0 + i_syn
    du = a * (b * v0 - u0)
    return v0 + dt * dv, u0 + dt * du, spike.to(v.dtype)


def fused_step_ref(
    v: Tensor,  # (n_p,)
    refrac: Tensor,  # (n_p,)
    i_tot: Tensor,  # (n_p,) total input current
    cols: Sequence[Tensor],  # per delay bucket (R, K_d) int32, local ids
    weights: Sequence[Tensor],  # per delay bucket (R, K_d)
    *,
    params: Dict[str, float],
) -> Tuple[Tensor, Tensor, Tensor, List[Tensor]]:
    """The fused per-partition step composed from the two plain versions:
    LIF advance + spike emission + per-bucket gather-accumulate.  Returns
    ``(v', refrac', spikes, currents)``."""
    v2, r2, s = lif_step_ref(v, refrac, i_tot, **params)
    currents = [spike_gather_ref(s, c, w) for c, w in zip(cols, weights)]
    return v2, r2, s, currents
