"""Training: the node-classification loop, its config, optimizer and metrics."""

from mma_tpu_torch.train.config import NODE_CLS_PRESETS, NodeClassificationConfig
from mma_tpu_torch.train.loops import node_train_step, train_node_classification
from mma_tpu_torch.train.metrics import accuracy, mae
from mma_tpu_torch.train.optim import ReduceLROnPlateau, make_optimizer

__all__ = [
    "NODE_CLS_PRESETS",
    "NodeClassificationConfig",
    "ReduceLROnPlateau",
    "accuracy",
    "mae",
    "make_optimizer",
    "node_train_step",
    "train_node_classification",
]
