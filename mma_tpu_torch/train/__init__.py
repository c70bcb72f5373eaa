"""Training: the node-classification, ZINC and sampled loops, their configs,
optimizer and metrics, checkpoints and the resilient step runner."""

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
from mma_tpu_torch.train.resilience import FailureRecord, ResilientRunner
from mma_tpu_torch.train.sampled import (
    DeviceTableAssembler,
    SampledTrainConfig,
    sampled_batch_producer,
    sampled_train_step,
    train_sampled,
)

__all__ = [
    "DeviceTableAssembler",
    "FailureRecord",
    "NODE_CLS_PRESETS",
    "NodeClassificationConfig",
    "ReduceLROnPlateau",
    "ResilientRunner",
    "SampledTrainConfig",
    "ZINC_PRESET",
    "ZincConfig",
    "accuracy",
    "mae",
    "make_optimizer",
    "node_train_step",
    "sampled_batch_producer",
    "sampled_train_step",
    "train_node_classification",
    "train_sampled",
    "train_zinc",
    "zinc_train_step",
]
