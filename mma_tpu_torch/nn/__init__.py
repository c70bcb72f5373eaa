from mma_tpu_torch.nn.gcn import GraphConvolution
from mma_tpu_torch.nn.layers import MLP, BatchNorm, Dense, Embedding, dropout
from mma_tpu_torch.nn.mma_conv import MultiMaskConv
from mma_tpu_torch.nn.mma_layer import MMALayer

__all__ = [
    "BatchNorm",
    "Dense",
    "Embedding",
    "GraphConvolution",
    "MLP",
    "MMALayer",
    "MultiMaskConv",
    "dropout",
]
