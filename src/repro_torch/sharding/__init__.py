"""repro_torch.sharding: the reference's spec rules (``specs``) as
tuples of mesh-axis entries and their DTensor placements, and the
activation constraints the models call (``activations``)."""
from repro_torch.sharding.specs import (
    ShardingRules,
    batch_spec,
    cache_specs,
    opt_state_specs,
    param_specs,
    placements,
)

__all__ = [
    "ShardingRules",
    "param_specs",
    "batch_spec",
    "cache_specs",
    "opt_state_specs",
    "placements",
]
