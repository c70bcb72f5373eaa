"""mma_tpu_torch — the MMA GNN framework on PyTorch, with CUDA kernels for Hopper.

A port of the JAX package ``mma_tpu``, which stays as the reference. The
port imports neither JAX nor ``mma_tpu``. Entry points place their data
and modules on the GPU unless given ``device="cpu"``; CPU tensors take
the plain PyTorch versions of the kernels and CUDA tensors the kernels
(``mma_tpu_torch.ops.cuda.fused_mma``), built with ``nvcc`` at first use.
"""

from mma_tpu_torch.data import load_planetoid, synthetic_powerlaw
from mma_tpu_torch.graph import (
    BatchedGraphs,
    Graph,
    graph_from_dense,
    graph_from_edges,
    graph_from_neighbor_lists,
)
from mma_tpu_torch.models import NodeClassifier, ZincNet
from mma_tpu_torch.nn import GraphConvolution, MMALayer, MultiMaskConv

__all__ = [
    "BatchedGraphs",
    "Graph",
    "GraphConvolution",
    "MMALayer",
    "MultiMaskConv",
    "NodeClassifier",
    "ZincNet",
    "graph_from_dense",
    "graph_from_edges",
    "graph_from_neighbor_lists",
    "load_planetoid",
    "synthetic_powerlaw",
]
