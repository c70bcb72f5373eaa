"""Data-parallel training for batched graph regression (ZINC).

The port of ``mma_tpu/parallel/data_parallel.py``. Each rank of the data
axis owns one :class:`BatchedGraphs` micro-batch and runs the whole model
on it. The loss is the global graph-count-weighted mean: each rank
backpropagates its error sum over the global graph count (all-reduced
without a gradient), and the parameter gradients are summed over the mesh
(the rule of :mod:`mma_tpu_torch.parallel.collectives`), so padding and a
ragged last batch stay exact. BatchNorm's batch statistics stay per rank
and its running buffers are averaged over the data axis after the forward:
the JAX package's synchronous-BN approximation (``:58``), not
``SyncBatchNorm``.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from mma_tpu_torch.graph.container import BatchedGraphs
from mma_tpu_torch.parallel.collectives import pmean_buffers, psum_grads, psum_no_grad


def stack_batches(batches: List[BatchedGraphs]) -> List[BatchedGraphs]:
    """The per-rank pieces, in rank order: the JAX package stacks them along a
    leading device axis; here rank ``r`` takes ``batches[r]``
    (:func:`shard_stacked_batch`). The batches must share their padded
    shapes, as a stack needs."""
    shapes = {(b.graph.n_node, b.graph.n_edge, b.n_graph) for b in batches}
    if len(shapes) != 1:
        raise ValueError(f"micro-batches of different padded shapes: {sorted(shapes)}")
    return list(batches)


def shard_stacked_batch(stacked: List[BatchedGraphs], mesh: DeviceMesh, axis: str = "data",
                        device=None) -> BatchedGraphs:
    """This rank's micro-batch, on ``device`` (default: the mesh's)."""
    if len(stacked) != mesh.size(mesh.mesh_dim_names.index(axis)):
        raise ValueError(f"{len(stacked)} micro-batches for a {axis} axis of "
                         f"{mesh.size(mesh.mesh_dim_names.index(axis))}")
    piece = stacked[mesh.get_local_rank(axis)]
    return piece.to(mesh.device_type if device is None else device)


def graph_l1_share(pred: torch.Tensor, batch: BatchedGraphs, axis_name):
    """``(share, loss)``: this rank's error sum over the global graph count
    (to backpropagate), and the global graph-count-weighted L1 loss
    (detached), JAX's ``psum(err) / max(psum(cnt), 1)``."""
    gm = batch.graph_mask.to(pred.dtype)
    err = (torch.abs(pred - batch.target) * gm).sum()
    cnt = torch.clamp(psum_no_grad(gm.sum(), axis_name), min=1.0)
    return err / cnt, psum_no_grad(err, axis_name) / cnt


def make_dp_train_step(model, opt, mesh: DeviceMesh, axis: str = "data"):
    """``step(batch, generator=None) -> loss``: one data-parallel step of a
    :class:`~mma_tpu_torch.models.ZincNet` on this rank's micro-batch.
    Message dropout draws from ``generator`` (one per rank, as the JAX
    package's per-device ``rng``). Returns the global loss, detached."""
    group = mesh.get_group(axis)

    def step(batch: BatchedGraphs, generator: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        pred = model(batch, training=True, generator=generator)
        pmean_buffers(model.buffers(), group)
        share, loss = graph_l1_share(pred, batch, group)
        share.backward()
        psum_grads(model.parameters())
        opt.step()
        return loss

    return step
