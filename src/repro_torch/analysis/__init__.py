"""Static checks of the port (counterpart of ``repro/analysis``).

:mod:`repro_torch.analysis.contracts` checks every step engine's declared
contract (``kernels/dispatch.py:ENGINE_CONTRACTS``) on every eligible
configuration of the selector.  The JAX package's HLO and lowering tools
(``analysis/hlo.py``, ``compat.py``, ``launch/hlo_analysis.py``) have no
counterpart: torch builds no HLO.
"""
