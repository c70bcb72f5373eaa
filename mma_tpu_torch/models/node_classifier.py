"""2-layer node-classification model: GCN → ReLU → dropout → MMA → log-softmax.

Reference: ``node_classification/models.py:12-68``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mma_tpu_torch.device import DeviceLike, resolve_device
from mma_tpu_torch.graph.container import Graph
from mma_tpu_torch.nn.gcn import GraphConvolution
from mma_tpu_torch.nn.layers import dropout
from mma_tpu_torch.nn.mma_layer import MMALayer
from mma_tpu_torch.ops.scalers import SCALER_NAMES


class NodeClassifier(nn.Module):
    def __init__(
        self,
        n_feat: int,
        n_hidden: int,
        n_class: int,
        aggregators: Sequence[str],
        scalers: Sequence[str] = SCALER_NAMES,
        dropout_rate: float = 0.5,
        activation: str = "new_sigmoid",
        sigmoid_k: float = 2.0,
        parity: bool = True,
        compute_dtype: str = "float32",
        *,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.dropout_rate = dropout_rate
        self.gc1 = GraphConvolution(n_feat, n_hidden, compute_dtype=compute_dtype,
                                    device=dev, generator=generator)
        self.mma = MMALayer(
            n_hidden, n_class, aggregators, scalers=scalers, activation=activation,
            sigmoid_k=sigmoid_k, mask_dropout=dropout_rate, parity=parity,
            compute_dtype=compute_dtype, device=dev, generator=generator,
        )

    def forward(self, x: torch.Tensor, graph: Graph, *, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Log-probabilities ``(N_pad, n_class)``; padding rows are unspecified.

        Dropout between the layers and on the aggregation masks is active
        only when ``training`` and a ``generator`` are given, as the JAX
        package's ``rng``. Mask dropout is not ported yet, so that request
        raises. On the GPU, call under ``torch.no_grad()``: the kernels
        have no backward yet.
        """
        h = torch.relu(self.gc1(x, graph))
        h = dropout(h, self.dropout_rate, generator if training else None)
        out = self.mma(h, graph, generator=generator if training else None)
        return torch.log_softmax(out, dim=-1)
