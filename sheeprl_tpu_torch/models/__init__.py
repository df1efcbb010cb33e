"""Neural building blocks (counterpart of ``sheeprl_tpu/models``)."""

from sheeprl_tpu_torch.models.models import CNN, MLP, LayerNormGRUCell
from sheeprl_tpu_torch.models.norm import FastLayerNorm

__all__ = ["CNN", "MLP", "FastLayerNorm", "LayerNormGRUCell"]
