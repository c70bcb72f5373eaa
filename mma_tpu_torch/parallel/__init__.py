"""The multi-device regimes over ``torch.distributed``: one process per
rank, a ``DeviceMesh`` whose dimension names are the JAX package's axis
names, and the gradient rule of :mod:`.collectives`. The node-sharded
(halo) regime of the JAX package is not ported yet."""

from mma_tpu_torch.parallel.collectives import (
    all_gather,
    axis_index,
    pmean,
    psum,
    psum_grads,
)
from mma_tpu_torch.parallel.data_parallel import (
    make_dp_train_step,
    shard_stacked_batch,
    stack_batches,
)
from mma_tpu_torch.parallel.dp_edge import (
    make_dp_edge_forward,
    make_dp_edge_train_step,
    shard_batches_dp_edge,
)
from mma_tpu_torch.parallel.edge_parallel import (
    graph_shard_spec,
    localize_graph,
    make_edge_sharded_forward,
    make_edge_sharded_train_step,
    pad_edges_for_sharding,
    shard_graph,
)
from mma_tpu_torch.parallel.mesh import initialize_distributed, launch_local, make_mesh

__all__ = [
    "all_gather",
    "axis_index",
    "graph_shard_spec",
    "initialize_distributed",
    "launch_local",
    "localize_graph",
    "make_dp_edge_forward",
    "make_dp_edge_train_step",
    "make_dp_train_step",
    "make_edge_sharded_forward",
    "make_edge_sharded_train_step",
    "make_mesh",
    "pad_edges_for_sharding",
    "pmean",
    "psum",
    "psum_grads",
    "shard_batches_dp_edge",
    "shard_graph",
    "shard_stacked_batch",
    "stack_batches",
]
