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
                generator: Optional[torch.Generator] = None,
                parity_eval_dropout: bool = False) -> torch.Tensor:
        """Log-probabilities ``(N_pad, n_class)``; padding rows are unspecified.

        ``generator`` plays the JAX package's ``rng`` (it must live on the
        model's device). Dropout sites, as there:

        - between the layers: only when ``training``;
        - on the aggregation masks: when ``training``, or in eval with
          ``parity_eval_dropout=True`` (the reference's always-on N2).

        Without a generator there is no dropout. The feature dropout draws
        from the generator first, then the mask dropout.
        """
        h = torch.relu(self.gc1(x, graph))
        h = dropout(h, self.dropout_rate, generator if training else None)
        mask_dropout_on = training or parity_eval_dropout
        out = self.mma(h, graph, generator=generator if mask_dropout_on else None)
        return torch.log_softmax(out, dim=-1)
