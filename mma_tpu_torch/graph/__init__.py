from mma_tpu_torch.graph.build import graph_from_edges
from mma_tpu_torch.graph.container import Graph

__all__ = ["Graph", "graph_from_edges"]
