"""Training: the node-classification and ZINC loops, their configs, optimizer and metrics."""

from mma_tpu_torch.train.config import (
    NODE_CLS_PRESETS,
    ZINC_PRESET,
    NodeClassificationConfig,
    ZincConfig,
)
from mma_tpu_torch.train.loops import (
    node_train_step,
    train_node_classification,
    train_zinc,
    zinc_train_step,
)
from mma_tpu_torch.train.metrics import accuracy, mae
from mma_tpu_torch.train.optim import ReduceLROnPlateau, make_optimizer

__all__ = [
    "NODE_CLS_PRESETS",
    "NodeClassificationConfig",
    "ReduceLROnPlateau",
    "ZINC_PRESET",
    "ZincConfig",
    "accuracy",
    "mae",
    "make_optimizer",
    "node_train_step",
    "train_node_classification",
    "train_zinc",
    "zinc_train_step",
]
