"""Deterministic fault injection for the port's robustness tests and the
card's chaos runs (the counterpart of the reference's ``repro.testing``)."""
from .fault_plans import (  # noqa: F401
    CHAOS_PLANS,
    KINDS,
    KNOWN_SITES,
    STATE_KINDS,
    Fault,
    FaultPlan,
    InjectedCrash,
    InjectedIOError,
    active_plans,
    apply_state_faults,
    chaos_plan,
    fault_point,
    file_crc,
    no_faults,
)
