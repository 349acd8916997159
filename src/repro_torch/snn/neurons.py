"""Vectorized neuron dynamics over padded dCSR vertex-state tuples.

Counterpart of ``repro/snn/neurons.py``.  Each model's update runs over the
full padded state array and a mask selects which rows it owns, which keeps
state aligned with the dCSR serialization.  LIF goes through the
``lif_step`` kernel; ALIF and Izhikevich run as plain torch, as the
reference runs them as jnp outside any Pallas kernel.

State layouts (``bias`` is the per-neuron constant input current):

  lif:        (v, refrac, bias)
  alif:       (v, refrac, adapt, bias)
  izhikevich: (v, u, bias)
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..core.state import ModelRegistry, ModelSpec
from ..kernels import ops, ref

# state-column indices per model
LIF_V, LIF_REF, LIF_BIAS = 0, 1, 2
ALIF_V, ALIF_REF, ALIF_ADAPT, ALIF_BIAS = 0, 1, 2, 3
IZH_V, IZH_U, IZH_BIAS = 0, 1, 2

STATE_LAYOUT = {
    "lif": ("v", "refrac", "bias"),
    "alif": ("v", "refrac", "adapt", "bias"),
    "izhikevich": ("v", "u", "bias"),
}

# the registry params the LIF kernels consume (single source for the
# neuron step and the fused step engine)
LIF_PARAM_KEYS = ("tau_m", "v_rest", "v_reset", "v_thresh", "t_ref", "r_m")


def registry_with_bias(reg: ModelRegistry) -> ModelRegistry:
    """The default registry with the bias-extended layouts above."""
    out = ModelRegistry()
    for s in reg.vertex_models():
        vars_ = STATE_LAYOUT.get(s.name, s.state_vars)
        out.register(ModelSpec(s.name, "vertex", vars_, dict(s.params)))
    for s in reg.edge_models():
        if s.name != "none":
            out.register(s)
    return out


def make_neuron_step(
    registry: ModelRegistry,
    models_present: Sequence[str],
    dt: float,
) -> Callable:
    """Returns step(vtx_model, vtx_state, i_syn) -> (vtx_state', spikes).

    ``models_present`` is the set of vertex models in this partition; each
    absent model costs nothing."""
    models_present = tuple(models_present)
    specs = {name: registry.spec(name) for name in models_present}
    ids = {name: registry.vertex_id(name) for name in models_present}

    def step(vtx_model, vtx_state, i_syn):
        new_state = vtx_state.clone()
        spikes = torch.zeros(
            vtx_state.shape[0], dtype=vtx_state.dtype, device=vtx_state.device
        )
        for name in models_present:
            p = dict(specs[name].params)
            mask = vtx_model == ids[name]
            maskf = mask.to(vtx_state.dtype)
            if name == "lif":
                i_tot = i_syn + vtx_state[:, LIF_BIAS]
                v, refr, s = ops.lif_step(
                    vtx_state[:, LIF_V].contiguous(),
                    vtx_state[:, LIF_REF].contiguous(),
                    i_tot,
                    params={**{k: p[k] for k in LIF_PARAM_KEYS}, "dt": dt},
                )
                new_state[:, LIF_V] = torch.where(mask, v, new_state[:, LIF_V])
                new_state[:, LIF_REF] = torch.where(
                    mask, refr, new_state[:, LIF_REF]
                )
            elif name == "alif":
                i_tot = i_syn + vtx_state[:, ALIF_BIAS]
                v, refr, adapt, s = ref.alif_step_ref(
                    vtx_state[:, ALIF_V], vtx_state[:, ALIF_REF],
                    vtx_state[:, ALIF_ADAPT], i_tot,
                    dt=dt, tau_m=p["tau_m"], v_rest=p["v_rest"],
                    v_reset=p["v_reset"], v_thresh=p["v_thresh"],
                    t_ref=p["t_ref"], r_m=p["r_m"],
                    tau_adapt=p["tau_adapt"], beta=p["beta"],
                )
                new_state[:, ALIF_V] = torch.where(mask, v, new_state[:, ALIF_V])
                new_state[:, ALIF_REF] = torch.where(
                    mask, refr, new_state[:, ALIF_REF]
                )
                new_state[:, ALIF_ADAPT] = torch.where(
                    mask, adapt, new_state[:, ALIF_ADAPT]
                )
            elif name == "izhikevich":
                i_tot = i_syn + vtx_state[:, IZH_BIAS]
                v, u, s = ref.izhikevich_step_ref(
                    vtx_state[:, IZH_V], vtx_state[:, IZH_U], i_tot,
                    dt=dt, a=p["a"], b=p["b"], c=p["c"], d=p["d"],
                )
                new_state[:, IZH_V] = torch.where(mask, v, new_state[:, IZH_V])
                new_state[:, IZH_U] = torch.where(mask, u, new_state[:, IZH_U])
            else:
                raise ValueError(f"no dynamics for vertex model {name!r}")
            spikes = spikes + maskf * s
        return new_state, spikes

    return step
