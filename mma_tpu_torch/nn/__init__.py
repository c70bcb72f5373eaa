from mma_tpu_torch.nn.gcn import GraphConvolution
from mma_tpu_torch.nn.layers import dropout
from mma_tpu_torch.nn.mma_layer import MMALayer

__all__ = ["GraphConvolution", "MMALayer", "dropout"]
