"""Kernel layer of the port: hand-written CUDA kernels for Hopper, each
beside its plain torch version, behind the ``ops`` entry points.

  - :mod:`.ops`          -- ``lif_step``, ``spike_gather``, ``fused_step``,
    ``event_post_exchange``, ``stdp_update``, ``fused_step_plastic``, and the
    split step's ``fused_pre_exchange`` and ``fused_post_exchange*``, the
    procedural construction's ``builder_keystream``, the simulator's
    per-step ``step_noise`` and ``step_noise_add``, the step front
    ``step_front`` of the split and event engines, the heavy-row split's
    ``segment_gather_ring``, and the unfused engine's ``stdp_update_step``
    (every bucket of a step in one launch)
  - :mod:`.dispatch`     -- backend by device, step-engine selection
  - :mod:`.ref`          -- the plain torch versions (correctness contract)
  - :mod:`.lif_step`, :mod:`.spike_gather`, :mod:`.fused_step`,
    :mod:`.event_step`, :mod:`.stdp_update`, :mod:`.split_step`,
    :mod:`.keystream`, :mod:`.noise`, :mod:`.step_front`,
    :mod:`.segment_gather` -- kernel wrappers
    with their launch counters
  - :mod:`._build`       -- builds ``csrc/*.cu`` on first use
"""
