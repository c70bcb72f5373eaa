from mma_tpu_torch.graph.build import graph_from_edges
from mma_tpu_torch.graph.container import BatchedGraphs, Graph

__all__ = ["BatchedGraphs", "Graph", "graph_from_edges"]
