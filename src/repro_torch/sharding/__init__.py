"""The LM substrate's sharding policy on a ``torch.distributed`` device
mesh, the counterpart of ``repro/sharding``."""
from .policy import (  # noqa: F401
    REPLICATED, Policy, activation_spec, assign_, attend, constrain, current_policy, dense,
    embedding, make_policy, param_spec, placements, policy_context, replicated, shard_model,
    split_last,
)
