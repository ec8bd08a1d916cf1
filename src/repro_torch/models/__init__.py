"""Model substrate of the port: the LM of every family of the reference
(dense, parallel-block, hybrid, MoE, encoder-decoder, VLM, xLSTM)."""
from repro_torch.models.common import (SHAPES, ModelConfig, ShapeSpec,
                                       shape_applicable)
from repro_torch.models.model import LM

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "shape_applicable", "LM"]
