from repro_torch.kernels.relagg.ops import grouped_aggregate

__all__ = ["grouped_aggregate"]
