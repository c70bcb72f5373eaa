"""Edge-partitioned execution of the node-classification stack.

The port of ``mma_tpu/parallel/edge_parallel.py``. The dst-sorted edge list
is split into contiguous, equal shards, one per rank of the edge axis;
node-level arrays (features, degrees, masks) and the parameters are
replicated. Every edge-driven reduction makes a full-size partial on its
shard, which :func:`~mma_tpu_torch.parallel.collectives.psum` combines
(``axis_name`` through ``binary_spmm`` and ``masked_multi_aggregate``). All
usable aggregators reduce neighbours by sum, so the partials are exact.

Each rank holds only its own shard (:func:`shard_graph`), where the JAX
package stacks the shards along a leading device axis. A shard always
carries its own CSR (``row_ptr`` over its edges): every route of the port
reduces over one, on the card with kernel 1, on the CPU with its plain
version. Its padding edges are the global list's tail, so they point at
the padding node in the last shards only, and ``Graph.real_row_ptr`` and
``real_col_ptr`` still skip exactly them. ``kernel_structure=True`` also
builds the shard's CSC (``src_perm``, ``col_ptr``, ``src_csc``,
``dst_csc``) on the host with :mod:`mma_tpu_torch.graph.native`, field for
field the JAX package's (``edge_parallel.py:114-144``), and the shard then
takes the fused lean route (kernels 2-3). Without it the shard has no CSC,
as in the JAX package, and takes the half-fused route; the src-keyed sums
of its backward derive the CSC order on the device.

Gradients follow the rule of :mod:`mma_tpu_torch.parallel.collectives`:
each rank backpropagates the replicated loss over the edge-axis size, the
in-graph ``psum`` all-reduces cotangents, and the parameter gradients are
summed over the mesh before the optimizer step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from mma_tpu_torch.graph import native
from mma_tpu_torch.graph.build import pad_graph
from mma_tpu_torch.graph.container import Graph
from mma_tpu_torch.parallel.collectives import axis_size, psum_grads


def pad_edges_for_sharding(graph: Graph, num_shards: int) -> Graph:
    """Host-side: re-pad the edge list so that it divides evenly into shards."""
    e = graph.n_edge
    e_pad = ((e + num_shards - 1) // num_shards) * num_shards
    if e_pad == e:
        return graph
    return pad_graph(graph, graph.n_node, e_pad)


def graph_shard_spec(axis: str, kernel_structure: bool = False) -> Dict[str, Optional[str]]:
    """What each ``Graph`` field holds on a rank: ``"sharded"`` along
    ``axis`` (this rank's contiguous slice, or the structure built over
    it), ``"replicated"``, or None (absent). The JAX package's spec tree of
    ``PartitionSpec``s, as documentation; the port's ranks each build their
    own piece (:func:`localize_graph`)."""
    csc = "sharded" if kernel_structure else None
    return {"src": "sharded", "dst": "sharded", "edge_mask": "sharded",
            "node_mask": "replicated", "deg": "replicated", "row_ptr": "sharded",
            "src_perm": csc, "col_ptr": csc, "src_csc": csc, "dst_csc": csc,
            "chunk_hint": None}


def localize_graph(graph: Graph, num_shards: int, shard: int,
                   kernel_structure: bool = False) -> Graph:
    """Shard ``shard`` of ``graph``'s edges (already padded to a multiple of
    ``num_shards``), on ``graph``'s device: its slice of the edge arrays, its
    own CSR and, with ``kernel_structure``, its own CSC; node arrays
    replicated."""
    n, e_loc = graph.n_node, graph.n_edge // num_shards
    if e_loc * num_shards != graph.n_edge:
        raise ValueError(f"{graph.n_edge} edges do not divide into {num_shards} shards; "
                         "pad them first (pad_edges_for_sharding)")
    lo, hi = shard * e_loc, (shard + 1) * e_loc
    src = graph.src[lo:hi].cpu().numpy()
    dst = graph.dst[lo:hi].cpu().numpy()
    dev = graph.src.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    fields = dict(src=graph.src[lo:hi].clone(), dst=graph.dst[lo:hi].clone(),
                  edge_mask=graph.edge_mask[lo:hi].clone(),
                  row_ptr=t(native.build_row_ptr(dst, n)), src_perm=None, col_ptr=None,
                  src_csc=None, dst_csc=None)
    if kernel_structure:
        _, s_sorted, perm = native.sort_edges(dst, src, n)
        fields.update(src_perm=t(perm), col_ptr=t(native.build_row_ptr(s_sorted, n)),
                      src_csc=t(s_sorted), dst_csc=t(dst[perm]))
    return dataclasses.replace(graph, chunk_hint=None, ell_hint=None, ell_exact=False,
                               csc_ell_exact=False, **fields)


def shard_graph(graph: Graph, mesh: DeviceMesh, axis: str = "edge",
                kernel_structure: bool = False) -> Graph:
    """This rank's shard of ``graph`` along the mesh axis ``axis``, on the
    graph's device (pad first, then :func:`localize_graph`)."""
    num_shards = mesh.size(mesh.mesh_dim_names.index(axis))
    graph = pad_edges_for_sharding(graph, num_shards)
    return localize_graph(graph, num_shards, mesh.get_local_rank(axis), kernel_structure)


def make_edge_sharded_forward(model, mesh: DeviceMesh, axis: str = "edge"):
    """``forward(x, graph) -> logp`` running edge-sharded: ``model`` is a
    :class:`~mma_tpu_torch.models.NodeClassifier`, ``x`` replicated,
    ``graph`` this rank's shard; the output is replicated. The route
    follows the shard (module docstring), where the JAX package takes
    ``use_pallas``."""
    group = mesh.get_group(axis)

    def forward(x: torch.Tensor, graph: Graph) -> torch.Tensor:
        return model(x, graph, training=False, axis_name=group)

    return forward


def make_edge_sharded_train_step(model, opt, mesh: DeviceMesh, labels: torch.Tensor,
                                 idx_train: torch.Tensor, axis: str = "edge"):
    """Full-batch training step with the edges sharded and the gradients
    exact: ``step(x, graph, generator=None) -> loss`` (the global NLL over
    ``idx_train``, detached; ``labels`` and ``idx_train`` int64).

    Dropout draws from ``generator``, which every rank of the axis must seed
    alike: the feature dropout acts on replicated node rows, and the mask
    dropout then draws the same pattern for each shard's edge block, as the
    JAX package's one ``rng`` does on every shard."""
    from mma_tpu_torch.train.loops import nll  # train imports this package

    group = mesh.get_group(axis)
    size = axis_size(group)

    def step(x: torch.Tensor, graph: Graph, generator: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        logp = model(x, graph, training=True, generator=generator, axis_name=group)
        loss = nll(logp, labels, idx_train)
        (loss / size).backward()
        psum_grads(model.parameters())
        opt.step()
        return loss.detach()

    return step
