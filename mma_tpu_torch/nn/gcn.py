"""pygcn-style graph convolution: ``A @ (X W) + b``.

Reference: ``node_classification/layers.py:12-51``. The adjacency is the
raw binary matrix — no normalization, no self-loops.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mma_tpu_torch.device import DeviceLike, check_compute_dtype, resolve_device
from mma_tpu_torch.graph.container import Graph
from mma_tpu_torch.nn import init as inits
from mma_tpu_torch.ops.spmm import binary_spmm


class GraphConvolution(nn.Module):
    """Parameters ``w`` ``(in, out)`` and ``b`` ``(out,)``, as in the JAX package."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: str = "float32", *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        check_compute_dtype(compute_dtype)
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype = compute_dtype
        # pygcn init: stdv = 1/√weight.size(1) (layers.py:32-36).
        self.w = nn.Parameter(
            inits.uniform_fan_out((in_features, out_features), generator).to(dev))
        self.b = (nn.Parameter(
            inits.uniform((out_features,), out_features ** -0.5, generator).to(dev))
            if bias else None)

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        out = binary_spmm(graph, x @ self.w)
        if self.b is not None:
            out = out + self.b
        return out
