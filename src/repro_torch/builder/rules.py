"""Declarative network specifications for procedural construction.

A copy of ``repro/builder/rules.py`` kept in the port: the same dataclasses,
presets and JSON form, so a spec round-trips between the two packages.

A :class:`RuleSpec` is a tiny, picklable description of a network — a
tuple of populations and a tuple of connectivity rules — from which the
builder (`repro_torch.builder.procedural`) emits each partition's dCSR rows
directly, without ever materializing the whole network on one host.

Every rule is *row-local*: the in-edges of a target row depend only on
``(seed, rule, global row)``, which is what makes construction
embarrassingly parallel across partitions and bit-identical for any
partition count or chunk size.

Three rule families cover the repo's legacy topologies:

- ``fan_in``    — exact per-row in-degree, sources uniform over the
                  source population (NEST's fixed-in-degree).
- ``p``         — pairwise-probability connectivity realized per row as
                  ``floor(lam) + Bernoulli(frac(lam))`` draws with
                  ``lam = p * n_src`` (fixed-total-number style; same
                  expected degree, row-local).
- ``kernel``    — distance-kernel connectivity: ``candidates`` uniform
                  proposals per row, each accepted with probability
                  ``p_max * max(0, 1 - d^2 / radius^2)``.  The kernel is
                  polynomial on purpose: no transcendental functions
                  means no cross-backend divergence.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from . import crng

_SYNAPSES = ("syn_static", "syn_stdp")


@dataclasses.dataclass(frozen=True)
class Population:
    """A contiguous block of neurons sharing a model and init distribution."""

    name: str
    n: int
    model: str = "lif"
    bias_mu: float = 14.5
    bias_sigma: float = 1.0
    v_uniform: bool = True  # v0 ~ U[v_reset, v_thresh); else v0 = v_init
    v_init: float = 0.0
    # (index, total): confine z coordinates to horizontal slab index/total.
    slab: Optional[Tuple[int, int]] = None

    def validate(self) -> None:
        if self.n <= 0:
            raise ValueError(f"population {self.name!r}: n must be positive, got {self.n}")
        if self.model != "lif":
            raise ValueError(
                f"population {self.name!r}: procedural construction currently "
                f"supports model='lif' only, got {self.model!r}"
            )
        if self.slab is not None and not (0 <= self.slab[0] < self.slab[1]):
            raise ValueError(f"population {self.name!r}: bad slab {self.slab}")


@dataclasses.dataclass(frozen=True)
class DistanceKernel:
    """Acceptance kernel p(d^2) = p_max * clip(1 - d^2 / radius^2, 0, 1)."""

    p_max: float
    radius: float

    def validate(self) -> None:
        if not (0.0 < self.p_max <= 1.0):
            raise ValueError(f"kernel p_max must be in (0, 1], got {self.p_max}")
        if self.radius <= 0.0:
            raise ValueError(f"kernel radius must be positive, got {self.radius}")


@dataclasses.dataclass(frozen=True)
class ConnectRule:
    """One (source population -> target population) connectivity rule.

    Exactly one of ``fan_in > 0``, ``p > 0``, ``kernel is not None``
    selects the rule family.  Weights are ``scale * f(mu + sigma * z)``
    with ``f = abs`` when ``weight_abs`` (z a counter-based normal);
    delays are a fixed step count, uniform over ``[1, delay_uniform]``,
    or proportional to distance up to ``delay_distance`` steps.
    """

    src: str
    dst: str
    fan_in: int = 0
    p: float = 0.0
    kernel: Optional[DistanceKernel] = None
    candidates: int = 0  # proposals per row for kernel rules
    no_self: bool = False
    weight_mu: float = 1.0
    weight_sigma: float = 0.0
    weight_abs: bool = False
    weight_scale: float = 1.0
    delay: int = 1
    delay_uniform: int = 0
    delay_distance: int = 0
    synapse: str = "syn_static"

    def validate(self) -> None:
        families = (self.fan_in > 0) + (self.p > 0.0) + (self.kernel is not None)
        if families != 1:
            raise ValueError(
                f"rule {self.src!r}->{self.dst!r}: exactly one of fan_in/p/kernel "
                f"must be set, got fan_in={self.fan_in} p={self.p} kernel={self.kernel}"
            )
        if self.kernel is not None:
            self.kernel.validate()
            if self.candidates <= 0:
                raise ValueError(
                    f"rule {self.src!r}->{self.dst!r}: kernel rules need candidates > 0"
                )
        if self.p > 1.0:
            raise ValueError(f"rule {self.src!r}->{self.dst!r}: p must be <= 1, got {self.p}")
        if self.synapse not in _SYNAPSES:
            raise ValueError(f"rule {self.src!r}->{self.dst!r}: unknown synapse {self.synapse!r}")
        if (self.delay_uniform > 0) and (self.delay_distance > 0):
            raise ValueError(
                f"rule {self.src!r}->{self.dst!r}: delay_uniform and delay_distance "
                "are mutually exclusive"
            )
        if self.delay < 1 and self.delay_uniform == 0 and self.delay_distance == 0:
            raise ValueError(f"rule {self.src!r}->{self.dst!r}: delay must be >= 1")


@dataclasses.dataclass(frozen=True)
class RuleSpec:
    """A complete procedural network description (populations + rules)."""

    populations: Tuple[Population, ...]
    rules: Tuple[ConnectRule, ...]
    seed: int = 0
    dt: float = 0.1
    noise_sigma: float = 0.5
    name: str = "rules"

    def __post_init__(self):
        object.__setattr__(self, "populations", tuple(self.populations))
        object.__setattr__(self, "rules", tuple(self.rules))
        names = [p.name for p in self.populations]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate population names: {names}")
        for p in self.populations:
            p.validate()
        for r in self.rules:
            r.validate()
            for end in (r.src, r.dst):
                if end not in names:
                    raise ValueError(f"rule references unknown population {end!r}")

    @property
    def n(self) -> int:
        return sum(p.n for p in self.populations)

    def offsets(self):
        """dict name -> (start, stop) global-id range of each population."""
        out, at = {}, 0
        for p in self.populations:
            out[p.name] = (at, at + p.n)
            at += p.n
        return out

    def meta(self) -> dict:
        return {
            "dt": float(self.dt),
            "noise_sigma": float(self.noise_sigma),
            "seed": float(self.seed),
            "builder": 1.0,
        }


# ---------------------------------------------------------------------------
# The repo's legacy topologies, re-expressed as rules.
# ---------------------------------------------------------------------------


def balanced_ei_rules(
    n: int = 1000,
    epsilon: float = 0.1,
    g: float = 5.0,
    w: float = 0.5,
    delay_steps: int = 15,
    stdp: bool = True,
    seed: int = 0,
) -> RuleSpec:
    """Brunel-style balanced E/I network as rules.

    Matches `snn.network.balanced_ei` in distribution: 80/20 E/I split,
    every neuron receives ``c_e = eps*n_e`` excitatory and ``c_i = eps*n_i``
    inhibitory inputs, E->E plastic when ``stdp``.
    """
    n_exc = int(0.8 * n)
    n_inh = n - n_exc
    c_e = max(1, int(epsilon * n_exc))
    c_i = max(1, int(epsilon * n_inh))
    pops = (
        Population("E", n_exc, bias_mu=14.8, bias_sigma=0.6),
        Population("I", n_inh, bias_mu=14.8, bias_sigma=0.6),
    )
    rules = []
    for dst in ("E", "I"):
        rules.append(
            ConnectRule(
                src="E", dst=dst, fan_in=c_e, no_self=True,
                weight_mu=w, delay_uniform=delay_steps,
                synapse="syn_stdp" if (stdp and dst == "E") else "syn_static",
            )
        )
        rules.append(
            ConnectRule(
                src="I", dst=dst, fan_in=c_i, no_self=True,
                weight_mu=-g * w, delay_uniform=delay_steps,
            )
        )
    return RuleSpec(pops, tuple(rules), seed=seed, dt=0.1, noise_sigma=0.8,
                    name="balanced_ei")


def microcircuit_rules(scale: float = 1.0, seed: int = 0, g: float = 4.0,
                       w_exc: float = 0.15) -> RuleSpec:
    """Potjans-Diesmann cortical microcircuit (scaled) as pairwise-p rules."""
    from ..snn.network import PD14_POPS, PD14_PROBS, PD14_SIZES

    sizes = [max(1, int(round(s * scale))) for s in PD14_SIZES]
    pops = tuple(
        Population(name, sz, bias_mu=15.2, bias_sigma=0.4, slab=(i, len(PD14_POPS)))
        for i, (name, sz) in enumerate(zip(PD14_POPS, sizes))
    )
    rules = []
    for ti, tgt in enumerate(PD14_POPS):
        for si, src in enumerate(PD14_POPS):
            p = float(PD14_PROBS[ti][si])
            if p <= 0.0:
                continue
            inh = src.endswith("i")
            rules.append(
                ConnectRule(
                    src=src, dst=tgt, p=p, no_self=(src == tgt),
                    weight_mu=(g * w_exc) if inh else w_exc,
                    weight_sigma=0.1 * w_exc, weight_abs=True,
                    weight_scale=-1.0 if inh else 1.0,
                    delay=8 if inh else 15,
                )
            )
    return RuleSpec(pops, tuple(rules), seed=seed, dt=0.1, noise_sigma=1.0,
                    name="microcircuit")


def spatial_random_rules(
    n: int = 1000,
    avg_degree: int = 20,
    inhibitory_frac: float = 0.2,
    g: float = 4.0,
    delay_max_steps: int = 12,
    weight_mu: float = 0.5,
    weight_sigma: float = 0.15,
    seed: int = 0,
) -> RuleSpec:
    """Distance-dependent random network as kernel rules.

    The legacy `spatial_random` keeps the nearest of 3x oversampled
    pairs and flips a per-edge inhibitory coin; the rule form splits the
    population into E/I blocks (same inhibitory fraction) and uses a
    polynomial distance kernel with matched expected degree: with
    ``radius = sqrt(3)`` (the unit-cube diameter) the kernel accepts a
    uniform candidate with mean probability ``p_max * (1 - E[d^2]/3) =
    p_max * 5/6``, so ``candidates = 2 * avg_degree`` and ``p_max = 0.6``
    give ``E[degree] = avg_degree``.
    """
    n_inh = int(round(inhibitory_frac * n))
    n_exc = n - n_inh
    kern = DistanceKernel(p_max=0.6, radius=3.0**0.5)
    cand = 2 * avg_degree
    pops = (
        Population("E", n_exc, bias_mu=14.5, bias_sigma=1.0),
        Population("I", n_inh, bias_mu=14.5, bias_sigma=1.0),
    )
    rules = []
    exc_share = n_exc / max(1, n)
    for dst in ("E", "I"):
        rules.append(
            ConnectRule(
                src="E", dst=dst, kernel=kern,
                candidates=max(1, int(round(cand * exc_share))), no_self=True,
                weight_mu=weight_mu, weight_sigma=weight_sigma, weight_abs=True,
                delay_distance=delay_max_steps,
            )
        )
        rules.append(
            ConnectRule(
                src="I", dst=dst, kernel=kern,
                candidates=max(1, int(round(cand * (1.0 - exc_share)))), no_self=True,
                weight_mu=weight_mu, weight_sigma=weight_sigma, weight_abs=True,
                weight_scale=-g, delay_distance=delay_max_steps,
            )
        )
    return RuleSpec(pops, tuple(rules), seed=seed, dt=0.1, noise_sigma=0.5,
                    name="spatial_random")


def spec_to_dict(spec: RuleSpec) -> dict:
    """JSON-able dict capturing a :class:`RuleSpec` exactly (tuples become
    lists; round-trips through :func:`spec_from_dict` bit-identically,
    which is what lets a snapshot manifest carry its generating spec for
    corrupt-shard topology regeneration)."""
    import json

    # asdict is recursive (pops/rules/kernel/slab); the json round-trip
    # canonicalizes tuples to lists so the dict compares equal before and
    # after living in a manifest file
    return json.loads(json.dumps(dataclasses.asdict(spec)))


def spec_from_dict(d: dict) -> RuleSpec:
    """Inverse of :func:`spec_to_dict` (re-validates on construction)."""
    pops = tuple(
        Population(**{**p, "slab": tuple(p["slab"]) if p.get("slab") else None})
        for p in d["populations"]
    )
    rules = tuple(
        ConnectRule(**{
            **r,
            "kernel": DistanceKernel(**r["kernel"]) if r.get("kernel") else None,
        })
        for r in d["rules"]
    )
    extra = {k: d[k] for k in ("seed", "dt", "noise_sigma", "name") if k in d}
    return RuleSpec(pops, rules, **extra)


def rule_streams(spec: RuleSpec):
    """Per-rule stream ids, for documentation/tests."""
    return [
        {
            "rule": i,
            "degree": crng.rule_stream(i, crng.DEGREE_OFF),
            "src": crng.rule_stream(i, crng.SRC_OFF),
            "accept": crng.rule_stream(i, crng.ACCEPT_OFF),
            "weight": crng.rule_stream(i, crng.WEIGHT_OFF),
            "delay": crng.rule_stream(i, crng.DELAY_OFF),
        }
        for i, _ in enumerate(spec.rules)
    ]
