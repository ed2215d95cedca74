from repro_torch.kernels.ssd_scan.ops import ssd_scan

__all__ = ["ssd_scan"]
