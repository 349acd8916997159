"""Model registry: the paper's ``.model`` dictionary as a first-class object.

A copy of ``repro.core.state`` kept in the port, which imports nothing of
the JAX package; builders here and there give byte-identical arrays.

The dCSR paper generalizes CSR's scalar non-zero to *tuples* of state attached
to vertices (neurons) and edges (synapses), with a model dictionary mapping
string model identifiers to tuple sizes and shared parameters.  This module is
that dictionary: every neuron/synapse model registers its name, its state
tuple layout, shared parameters, and its (vectorized) dynamics.

State is stored padded to the registry-wide maximum tuple size so that a
heterogeneous partition is a single dense ``(n_p, max_size)`` array — the
TPU-friendly representation of "tuples of values associated with the row
array".
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# Special model identifier from the paper: an edge present in the symmetrized
# adjacency (outgoing-only) that carries no incoming-synapse state.
NONE_MODEL = "none"


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """One entry of the ``.model`` dictionary."""

    name: str
    kind: str  # "vertex" | "edge"
    state_vars: Tuple[str, ...]  # ordered tuple layout
    params: Dict[str, float]  # shared model parameters (paper: shared params)

    @property
    def state_size(self) -> int:
        return len(self.state_vars)

    def default_state(self) -> np.ndarray:
        return np.zeros((self.state_size,), dtype=np.float32)


class ModelRegistry:
    """Ordered registry of vertex and edge models.

    Integer ids are stable insertion order; id 0 of the edge table is always
    the paper's ``none`` model (state size 0).
    """

    def __init__(self) -> None:
        self._vertex: List[ModelSpec] = []
        self._edge: List[ModelSpec] = [
            ModelSpec(NONE_MODEL, "edge", (), {})
        ]
        self._by_name: Dict[str, ModelSpec] = {NONE_MODEL: self._edge[0]}

    # -- registration -----------------------------------------------------
    def register(self, spec: ModelSpec) -> int:
        if spec.name in self._by_name:
            raise ValueError(f"model {spec.name!r} already registered")
        table = self._vertex if spec.kind == "vertex" else self._edge
        table.append(spec)
        self._by_name[spec.name] = spec
        return len(table) - 1

    # -- lookup ------------------------------------------------------------
    def vertex_models(self) -> Sequence[ModelSpec]:
        return tuple(self._vertex)

    def edge_models(self) -> Sequence[ModelSpec]:
        return tuple(self._edge)

    def spec(self, name: str) -> ModelSpec:
        return self._by_name[name]

    def vertex_id(self, name: str) -> int:
        for i, s in enumerate(self._vertex):
            if s.name == name:
                return i
        raise KeyError(name)

    def edge_id(self, name: str) -> int:
        for i, s in enumerate(self._edge):
            if s.name == name:
                return i
        raise KeyError(name)

    @property
    def max_vertex_state(self) -> int:
        return max((s.state_size for s in self._vertex), default=0)

    @property
    def max_edge_state(self) -> int:
        return max((s.state_size for s in self._edge), default=0)

    # -- (de)serialization of the .model file shape ------------------------
    def to_entries(self) -> List[Tuple[str, str, int, Dict[str, float]]]:
        out = []
        for s in self._vertex:
            out.append((s.name, "vertex", s.state_size, dict(s.params)))
        for s in self._edge:
            out.append((s.name, "edge", s.state_size, dict(s.params)))
        return out

    @classmethod
    def from_entries(
        cls, entries: Sequence[Tuple[str, str, int, Dict[str, float]]],
        var_names: Optional[Dict[str, Tuple[str, ...]]] = None,
    ) -> "ModelRegistry":
        reg = cls()
        for name, kind, size, params in entries:
            if name == NONE_MODEL:
                continue  # implicit
            vars_ = (var_names or {}).get(name) or tuple(
                f"s{i}" for i in range(size)
            )
            reg.register(ModelSpec(name, kind, vars_, dict(params)))
        return reg


# ---------------------------------------------------------------------------
# Default model library (the paper's "most widely supported" models, Fugu-style)
# ---------------------------------------------------------------------------

def default_registry() -> ModelRegistry:
    reg = ModelRegistry()
    # Vertex (neuron) models -- state layouts documented per model.
    reg.register(ModelSpec(
        "lif", "vertex", ("v", "refrac"),
        dict(tau_m=10.0, v_rest=-65.0, v_reset=-65.0, v_thresh=-50.0,
             t_ref=2.0, r_m=1.0),
    ))
    reg.register(ModelSpec(
        "alif", "vertex", ("v", "refrac", "adapt"),
        dict(tau_m=10.0, v_rest=-65.0, v_reset=-65.0, v_thresh=-50.0,
             t_ref=2.0, r_m=1.0, tau_adapt=100.0, beta=0.2),
    ))
    reg.register(ModelSpec(
        "izhikevich", "vertex", ("v", "u"),
        dict(a=0.02, b=0.2, c=-65.0, d=8.0),
    ))
    # Edge (synapse) models.  Layout convention: state[0] = weight,
    # state[1] = delay (integer steps, stored as float), rest model-specific.
    reg.register(ModelSpec(
        "syn_static", "edge", ("weight", "delay"), {},
    ))
    reg.register(ModelSpec(
        "syn_stdp", "edge", ("weight", "delay"),
        dict(a_plus=0.01, a_minus=0.012, tau_plus=20.0, tau_minus=20.0,
             w_min=0.0, w_max=10.0),
    ))
    return reg


# Convenience: column indices of the common edge-state layout.
EDGE_WEIGHT = 0
EDGE_DELAY = 1
