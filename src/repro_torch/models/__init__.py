"""Port of ``src/repro/models``: the LM model zoo's dense-attention and
Mamba-2 decoders, for serving, and the dense ones' training loss."""
from repro_torch.models.config import SHAPES, ArchConfig, LayerSpec, ShapeConfig
from repro_torch.models.model_zoo import Model, build_model, input_specs

__all__ = ["SHAPES", "ArchConfig", "LayerSpec", "ShapeConfig", "Model",
           "build_model", "input_specs"]
