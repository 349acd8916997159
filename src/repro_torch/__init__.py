"""PyTorch/CUDA port of the dCSR spiking-network simulator.

The JAX package ``repro`` is the reference; this package imports ``torch``
and nothing of ``jax`` or ``repro``.  Its layout mirrors ``src/repro/`` so
each module's counterpart is found under the same path:

  - :mod:`repro_torch.core`    -- dCSR layout, partitioners, delay-bucketed ELL
  - :mod:`repro_torch.kernels` -- hand-written CUDA kernels for Hopper, each
    beside its plain torch version, and the ``ops`` entry points
  - :mod:`repro_torch.builder` -- procedural construction from a
    ``RuleSpec``, with the Threefry keystream on the card
  - :mod:`repro_torch.snn`     -- network builders, the k=1 simulator, the
    k>1 ``DistSimulator``, ``Session`` and monitors
  - :mod:`repro_torch.convert` -- carries networks and step state across from
    the reference's numpy arrays

Entry points run on the card; they use the CPU only when the caller passes
``device="cpu"``, and raise when there is no card and no such request.
"""
