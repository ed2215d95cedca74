"""Port of the sharding half of ``src/repro/dist``: parameter, batch and
cache sharding rules for the production meshes, and :func:`place`.  The
activation constraints and the int8 gradient compression wait for
training (ROADMAP A16)."""
from repro_torch.dist.sharding import (
    NamedSharding,
    PartitionSpec,
    batch_sharding,
    batch_specs,
    cache_specs,
    data_axis_size,
    param_specs,
    pick_data_axes,
    place,
    positions,
    replicated_sharding,
    shardings_for,
    to_device,
)

__all__ = [
    "PartitionSpec", "NamedSharding", "param_specs", "batch_specs",
    "cache_specs", "shardings_for", "pick_data_axes", "data_axis_size",
    "batch_sharding", "replicated_sharding", "place", "positions", "to_device",
]
