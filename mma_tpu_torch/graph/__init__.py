from mma_tpu_torch.graph.build import (
    graph_from_dense,
    graph_from_edges,
    graph_from_neighbor_lists,
    pad_graph,
)
from mma_tpu_torch.graph.container import BatchedGraphs, Graph

__all__ = [
    "BatchedGraphs",
    "Graph",
    "graph_from_dense",
    "graph_from_edges",
    "graph_from_neighbor_lists",
    "pad_graph",
]
