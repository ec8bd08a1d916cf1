"""Model substrate of the port: the LM of the dense (parallel blocks
too), hybrid, MoE and encoder-decoder families."""
from repro_torch.models.common import SHAPES, ModelConfig, ShapeSpec
from repro_torch.models.model import LM

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "LM"]
