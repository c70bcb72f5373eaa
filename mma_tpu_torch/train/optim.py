"""Optimizers and schedules with reference-matching semantics.

N11: both reference stacks use ``torch.optim.Adam(weight_decay=…)``
(``train.py:69-70``, ``mma.py:136``) — L2 *added to the gradient before*
the Adam moments, not AdamW's decoupled decay. The JAX package builds that
chain by hand (``add_decayed_weights → scale_by_adam → lr``); here it is
``torch.optim.Adam`` itself, with the same betas and eps.

``ReduceLROnPlateau`` is a copy of the JAX package's host-side scheduler
(``mma_tpu/train/optim.py:59-82``): torch's semantics with the
reference's settings (mode='min', factor=0.5, patience=20, min_lr=1e-5;
``mma.py:137``), including the relative-threshold default.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    learning_rate: float,
    weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> torch.optim.Adam:
    """Adam with L2 in the gradient (N11)."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay)


@dataclasses.dataclass
class ReduceLROnPlateau:
    """Host-side plateau scheduler (torch semantics, mode='min')."""

    lr: float
    factor: float = 0.5
    patience: int = 20
    min_lr: float = 1e-5
    threshold: float = 1e-4  # torch default, relative mode

    best: float = float("inf")
    num_bad: int = 0

    def step(self, metric: float) -> float:
        """Feed a validation metric; returns the (possibly reduced) lr."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr
