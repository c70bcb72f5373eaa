"""ZINC graph-regression model: embeddings → L×(conv, BN, ReLU) → pool → MLP.

The port of the JAX package's ``ZincNet`` (``mma_tpu/models/zinc_net.py``;
reference ``graph_regression/mma.py:63-127``), with the same config fields
and parameter names.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from mma_tpu_torch.device import DeviceLike, resolve_device
from mma_tpu_torch.graph.container import BatchedGraphs
from mma_tpu_torch.nn.layers import MLP, BatchNorm, Embedding
from mma_tpu_torch.nn.mma_conv import MultiMaskConv, Seed
from mma_tpu_torch.ops.cuda.fused_mma import segment_sum_csr


class ZincNet(nn.Module):
    """Per-graph predictions ``(G,)`` from a :class:`BatchedGraphs`.

    Submodules ``node_emb``, ``edge_emb``, ``conv{i}``, ``bn{i}`` (masked
    BatchNorm, running statistics as buffers) and ``mlp``. The JAX
    package's ``max_degree_hint`` (the TPU kernels' scan bound) has no
    counterpart: the CUDA kernels walk each row's edges. ``remat=True`` is
    not ported yet and raises.
    """

    def __init__(
        self,
        aggregators: Sequence[str],
        scalers: Sequence[str],
        avg_deg: Union[Mapping[str, float], Sequence],
        num_layers: int = 4,
        hidden: int = 75,
        edge_hidden: int = 50,
        num_node_types: int = 21,
        num_edge_types: int = 4,
        towers: int = 5,
        pre_layers: int = 1,
        post_layers: int = 1,
        mlp_sizes: Tuple[int, ...] = (75, 50, 25, 1),
        parity: bool = True,
        remat: bool = False,
        compute_dtype: str = "float32",
        edge_format: str = "auto",
        *,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if remat:
            raise NotImplementedError("remat (activation checkpointing) is not ported yet")
        dev = resolve_device(device)
        kw = dict(device=dev, generator=generator)
        self.num_layers = num_layers
        self.node_emb = Embedding(num_node_types, hidden, **kw)
        self.edge_emb = Embedding(num_edge_types, edge_hidden, **kw)
        self.mlp = MLP(mlp_sizes, **kw)
        for i in range(num_layers):
            self.add_module(f"conv{i}", MultiMaskConv(
                hidden, hidden, aggregators, scalers, avg_deg, edge_dim=edge_hidden,
                towers=towers, pre_layers=pre_layers, post_layers=post_layers,
                divide_input=False, parity=parity, compute_dtype=compute_dtype,
                edge_format=edge_format, **kw))
            self.add_module(f"bn{i}", BatchNorm(hidden, device=dev))

    def forward(self, batch: BatchedGraphs, *, training: bool = False,
                generator: Optional[torch.Generator] = None,
                seeds: Optional[Sequence[Seed]] = None,
                parity_eval_dropout: bool = False) -> torch.Tensor:
        """Per-graph predictions ``(G,)``; a training forward also updates
        the BatchNorm running statistics.

        Message dropout follows N2: on when ``training`` or
        ``parity_eval_dropout``, and a ``generator`` (on the model's device)
        or per-layer ``seeds`` (each as ``MultiMaskConv.forward``'s
        ``seed``) is given.
        """
        if not batch.nodes_grouped:
            raise NotImplementedError("degree-ordered batches are not ported yet")
        g = batch.graph
        x = self.node_emb(batch.node_feat)
        e = self.edge_emb(batch.edge_feat)
        dropout_on = training or parity_eval_dropout
        for i in range(self.num_layers):
            h = getattr(self, f"conv{i}")(
                x, g, e,
                generator=generator if dropout_on else None,
                seed=seeds[i] if dropout_on and seeds is not None else None)
            h = getattr(self, f"bn{i}")(h, g.node_mask, training=training)
            x = torch.relu(h)
        x = torch.where(g.node_mask[:, None], x, 0.0)
        # Each graph's nodes are one contiguous range (padding nodes in the
        # last graph's, zeroed above): a segment sum over graph_ptr.
        pooled = segment_sum_csr(x, batch.graph_ptr)
        return self.mlp(pooled).squeeze(-1)
