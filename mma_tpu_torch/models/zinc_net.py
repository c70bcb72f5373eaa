"""ZINC graph-regression model: embeddings → L×(conv, BN, ReLU) → pool → MLP.

The port of the JAX package's ``ZincNet`` (``mma_tpu/models/zinc_net.py``;
reference ``graph_regression/mma.py:63-127``), with the same config fields
and parameter names. ``axis_name`` runs the convs on an edge shard of the
batch (``mma_tpu_torch.parallel.dp_edge``; the JAX package's
``mma_tpu/models/zinc_net.py:112-133``): BatchNorm, pooling and the head
see replicated node arrays and compute replicated within the edge group.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.utils.checkpoint
from torch import nn

from mma_tpu_torch.device import DeviceLike, resolve_device
from mma_tpu_torch.graph.container import BatchedGraphs
from mma_tpu_torch.nn.layers import MLP, BatchNorm, Embedding
from mma_tpu_torch.nn.mma_conv import MultiMaskConv, Seed
from mma_tpu_torch.ops.cuda.fused_mma import segment_sum_csr
from mma_tpu_torch.parallel.collectives import AxisName


class ZincNet(nn.Module):
    """Per-graph predictions ``(G,)`` from a :class:`BatchedGraphs`.

    Submodules ``node_emb``, ``edge_emb``, ``conv{i}``, ``bn{i}`` (masked
    BatchNorm, running statistics as buffers) and ``mlp``.
    ``max_degree_hint`` sets the convs' slot width under
    ``edge_format="ell"`` (see ``MultiMaskConv``). ``remat=True`` recomputes
    each conv in the backward pass (``torch.utils.checkpoint``) instead of
    keeping its activations.
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
        max_degree_hint: Optional[int] = None,
        compute_dtype: str = "float32",
        edge_format: str = "auto",
        *,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, generator=generator)
        self.num_layers, self.remat = num_layers, remat
        self.node_emb = Embedding(num_node_types, hidden, **kw)
        self.edge_emb = Embedding(num_edge_types, edge_hidden, **kw)
        self.mlp = MLP(mlp_sizes, **kw)
        for i in range(num_layers):
            self.add_module(f"conv{i}", MultiMaskConv(
                hidden, hidden, aggregators, scalers, avg_deg, edge_dim=edge_hidden,
                towers=towers, pre_layers=pre_layers, post_layers=post_layers,
                divide_input=False, parity=parity, compute_dtype=compute_dtype,
                edge_format=edge_format, max_degree_hint=max_degree_hint, **kw))
            self.add_module(f"bn{i}", BatchNorm(hidden, device=dev))

    def forward(self, batch: BatchedGraphs, *, training: bool = False,
                generator: Optional[torch.Generator] = None,
                seeds: Optional[Sequence[Seed]] = None,
                parity_eval_dropout: bool = False,
                axis_name: AxisName = None) -> torch.Tensor:
        """Per-graph predictions ``(G,)``; a training forward also updates
        the BatchNorm running statistics.

        Message dropout follows N2: on when ``training`` or
        ``parity_eval_dropout``, and a ``generator`` (on the model's device)
        or per-layer ``seeds`` (each as ``MultiMaskConv.forward``'s
        ``seed``) is given.
        """
        g = batch.graph
        x = self.node_emb(batch.node_feat)
        e = self.edge_emb(batch.edge_feat)
        dropout_on = training or parity_eval_dropout
        for i in range(self.num_layers):
            conv = getattr(self, f"conv{i}")
            gen = generator if dropout_on else None
            seed = seeds[i] if dropout_on and seeds is not None else None
            if self.remat and torch.is_grad_enabled():
                h = _checkpointed(conv, x, g, e, gen, seed, axis_name)
            else:
                h = conv(x, g, e, generator=gen, seed=seed, axis_name=axis_name)
            h = getattr(self, f"bn{i}")(h, g.node_mask, training=training)
            x = torch.relu(h)
        x = torch.where(g.node_mask[:, None], x, 0.0)
        if batch.nodes_grouped:
            # Each graph's nodes are one contiguous range (padding nodes in
            # the last graph's, zeroed above): a segment sum over graph_ptr.
            pooled = segment_sum_csr(x, batch.graph_ptr)
        else:
            pooled = _PoolByGraph.apply(x, batch.graph_ptr, batch.node_order,
                                        batch.node_to_graph)
        return self.mlp(pooled).squeeze(-1)


class _PoolByGraph(torch.autograd.Function):
    """The per-graph sum of a batch whose graphs' nodes interleave: kernel 1
    over ``graph_ptr``, reading the rows through ``node_order`` (the nodes
    sorted by graph). Every node lies in exactly one graph's range, so the
    VJP is the gather ``ct[node_to_graph]``, no scatter."""

    @staticmethod
    def forward(ctx, x, graph_ptr, node_order, node_to_graph):
        ctx.save_for_backward(node_to_graph)
        return segment_sum_csr(x.contiguous(), graph_ptr, index=node_order)

    @staticmethod
    def backward(ctx, ct):
        (node_to_graph,) = ctx.saved_tensors
        return ct.index_select(0, node_to_graph.long()), None, None, None


def _checkpointed(conv: MultiMaskConv, x, graph, e, generator, seed, axis_name):
    """``conv(x, graph, e, ...)`` with its activations recomputed in the
    backward pass. ``torch.utils.checkpoint`` restores the global RNG
    state, not an explicit generator's, so the first run draws from
    ``generator`` itself (advancing it as an unchecked run would) and the
    recompute from a copy of its state before that run: both draw the same
    dropout masks and hash seeds."""
    state = None if generator is None else generator.get_state()
    runs = []

    def run(x_, e_):
        gen = generator
        if runs and generator is not None:
            gen = torch.Generator(device=generator.device)
            gen.set_state(state)
        runs.append(None)
        return conv(x_, graph, e_, generator=gen, seed=seed, axis_name=axis_name)

    return torch.utils.checkpoint.checkpoint(run, x, e, use_reentrant=False)
