"""Port of ``src/repro/dist``: the activation-sharding context
(:func:`shard_batch` is the identity on one process), parameter, batch and
cache sharding rules for the production meshes, :func:`place`, and the
int8 error-feedback gradient compression."""
from repro_torch.dist.activations import (
    clear_activation_mesh,
    current_activation_mesh,
    set_activation_mesh,
    shard_batch,
)
from repro_torch.dist.compress import (
    compress_tree,
    decompress_tree,
    dequantize_int8,
    ef_quantize,
    init_error_tree,
    quantize_int8,
)
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
    "set_activation_mesh", "clear_activation_mesh", "current_activation_mesh",
    "shard_batch", "PartitionSpec", "NamedSharding", "param_specs", "batch_specs",
    "cache_specs", "shardings_for", "pick_data_axes", "data_axis_size",
    "batch_sharding", "replicated_sharding", "place", "positions", "to_device",
    "compress_tree", "decompress_tree", "init_error_tree", "quantize_int8",
    "dequantize_int8", "ef_quantize",
]
