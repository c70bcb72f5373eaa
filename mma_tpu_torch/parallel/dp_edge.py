"""2-D (data × edge) parallel training for batched graph regression.

The port of ``mma_tpu/parallel/dp_edge.py``. Each group of the *data* axis
owns one :class:`BatchedGraphs` micro-batch (as in :mod:`.data_parallel`);
within the group, the micro-batch's disjoint-union edge list is split into
contiguous shards across the *edge* axis (as in :mod:`.edge_parallel`),
with node-level arrays replicated inside the group. The convs' partial
reductions combine across the edge axis with each reduction's own monoid
(``MultiMaskConv._reduce``: ``psum``, or ``all_gather`` then a max or min);
BatchNorm, pooling and the head compute replicated within the group. The
loss is the global graph-count-weighted mean across data groups.

Gradients follow the rule of :mod:`mma_tpu_torch.parallel.collectives`:
each rank backpropagates its group's error sum over the global graph count
and over the edge-axis size, and the parameter gradients are summed over
the whole mesh. BatchNorm's running buffers are averaged over the data axis
only (``dp_edge.py:185``): they are equal within an edge group.

A shard carries its own CSR and no CSC, as the JAX package strips the
structure there (``dp_edge.py:102-109``): the convs take the general CSR
route over the shard's edges, and the src-keyed sums of their backward
derive the CSC order on the device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from mma_tpu_torch.graph.build import pad_graph
from mma_tpu_torch.graph.container import BatchedGraphs
from mma_tpu_torch.parallel.collectives import axis_size, pmean_buffers, psum_grads
from mma_tpu_torch.parallel.data_parallel import graph_l1_share
from mma_tpu_torch.parallel.edge_parallel import localize_graph


def _pad_batch_edges(batch: BatchedGraphs, multiple: int) -> BatchedGraphs:
    """Host-side: re-pad the batch's edges to a multiple of ``multiple``
    (padding edges point at the padding node; their edge features are 0)."""
    e = batch.graph.n_edge
    e_pad = ((e + multiple - 1) // multiple) * multiple
    if e_pad == e:
        return batch
    graph = pad_graph(batch.graph, batch.graph.n_node, e_pad)
    edge_feat = batch.edge_feat
    if edge_feat is not None:
        pad = edge_feat.new_zeros((e_pad - e,) + tuple(edge_feat.shape[1:]))
        edge_feat = torch.cat([edge_feat, pad])
    return dataclasses.replace(batch, graph=graph, edge_feat=edge_feat)


def _localize_batch(batch: BatchedGraphs, num_shards: int, shard: int) -> BatchedGraphs:
    """Edge shard ``shard`` of ``batch`` (padded to a multiple of
    ``num_shards`` first): the shard's graph (:func:`localize_graph`, no
    CSC) and edge features; node- and graph-level arrays whole."""
    batch = _pad_batch_edges(batch, num_shards)
    e_loc = batch.graph.n_edge // num_shards
    edge_feat = batch.edge_feat
    if edge_feat is not None:
        edge_feat = edge_feat[shard * e_loc:(shard + 1) * e_loc].clone()
    return dataclasses.replace(batch, graph=localize_graph(batch.graph, num_shards, shard),
                               edge_feat=edge_feat)


def shard_batches_dp_edge(batches: List[BatchedGraphs], mesh: DeviceMesh,
                          data_axis: str = "data", edge_axis: str = "edge",
                          device=None) -> BatchedGraphs:
    """This rank's piece of one micro-batch per data group, on ``device``
    (default: the mesh's): micro-batch ``data index``, edge shard ``edge
    index``. ``len(batches)`` must equal the data axis's size."""
    dims = mesh.mesh_dim_names
    if len(batches) != mesh.size(dims.index(data_axis)):
        raise ValueError(f"{len(batches)} micro-batches for a {data_axis} axis of "
                         f"{mesh.size(dims.index(data_axis))}")
    piece = _localize_batch(batches[mesh.get_local_rank(data_axis)],
                            mesh.size(dims.index(edge_axis)), mesh.get_local_rank(edge_axis))
    return piece.to(mesh.device_type if device is None else device)


def make_dp_edge_forward(model, mesh: DeviceMesh, data_axis: str = "data",
                         edge_axis: str = "edge"):
    """``forward(batch) -> (G,)``: the eval-mode predictions of this rank's
    data group (replicated within the group)."""
    del data_axis  # the forward combines over the edge axis only
    group = mesh.get_group(edge_axis)

    def forward(batch: BatchedGraphs) -> torch.Tensor:
        return model(batch, training=False, axis_name=group)

    return forward


def make_dp_edge_train_step(model, opt, mesh: DeviceMesh, data_axis: str = "data",
                            edge_axis: str = "edge"):
    """``step(batch, seed=None) -> loss`` on the 2-D mesh: ``batch`` is this
    rank's piece (:func:`shard_batches_dp_edge`); returns the global loss,
    detached.

    ``seed`` (an int per data group, None for a deterministic step) turns on
    message dropout. Each edge shard folds in its edge index, as the JAX
    package folds ``axis_index(edge)`` into its group's key
    (``dp_edge.py:176-179``): the step's generator is seeded with ``seed ·
    edge_size + edge_index``, so shards draw apart and nothing else does
    (ZincNet draws dropout on edge messages only)."""
    data_group, edge_group = mesh.get_group(data_axis), mesh.get_group(edge_axis)
    edge_size = axis_size(edge_group)
    edge_index = mesh.get_local_rank(edge_axis)

    def step(batch: BatchedGraphs, seed: Optional[int] = None) -> torch.Tensor:
        generator = None
        if seed is not None:
            generator = torch.Generator(device=batch.graph.src.device)
            generator.manual_seed(int(seed) * edge_size + edge_index)
        opt.zero_grad(set_to_none=True)
        pred = model(batch, training=True, generator=generator, axis_name=edge_group)
        pmean_buffers(model.buffers(), data_group)
        share, loss = graph_l1_share(pred, batch, data_group)
        (share / edge_size).backward()
        psum_grads(model.parameters())
        opt.step()
        return loss

    return step
