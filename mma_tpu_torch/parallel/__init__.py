"""The multi-device regimes over ``torch.distributed``: one process per
rank, a ``DeviceMesh`` whose dimension names are the JAX package's axis
names, and the gradient rule of :mod:`.collectives`: the data-parallel,
edge-sharded, 2-D (data × edge) and node-sharded (halo) regimes."""

from mma_tpu_torch.parallel.collectives import (
    all_gather,
    all_to_all,
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
from mma_tpu_torch.parallel.node_sharded import (
    NodeShardedGraph,
    build_node_sharded,
    build_node_sharded_ordered,
    halo_exchange,
    make_node_sharded_forward,
    make_node_sharded_train_step,
    partition_order,
    place_on_mesh,
    shard_node_values,
)

__all__ = [
    "NodeShardedGraph",
    "all_gather",
    "all_to_all",
    "axis_index",
    "build_node_sharded",
    "build_node_sharded_ordered",
    "graph_shard_spec",
    "halo_exchange",
    "initialize_distributed",
    "launch_local",
    "localize_graph",
    "make_dp_edge_forward",
    "make_dp_edge_train_step",
    "make_dp_train_step",
    "make_edge_sharded_forward",
    "make_edge_sharded_train_step",
    "make_mesh",
    "make_node_sharded_forward",
    "make_node_sharded_train_step",
    "pad_edges_for_sharding",
    "partition_order",
    "place_on_mesh",
    "pmean",
    "psum",
    "psum_grads",
    "shard_batches_dp_edge",
    "shard_graph",
    "shard_node_values",
    "shard_stacked_batch",
    "stack_batches",
]
