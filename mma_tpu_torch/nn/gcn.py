"""pygcn-style graph convolution: ``A @ (X W) + b``.

Reference: ``node_classification/layers.py:12-51``. The adjacency is the
raw binary matrix — no normalization, no self-loops.

``compute_dtype`` (``"float32"``, ``"bfloat16"`` or ``"auto"``, resolved by
:func:`mma_tpu_torch.autotune.resolve_compute_dtype` on the layer's device)
is the SpMM operand's dtype: ``X W`` is cast to it after the float32
product, and the sum stays float32, as in the JAX package.

``axis_name`` runs the SpMM on an edge shard (``binary_spmm``; the JAX
package's ``mma_tpu/nn/gcn.py:39-44``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mma_tpu_torch.autotune import torch_compute_dtype
from mma_tpu_torch.device import DeviceLike, resolve_device
from mma_tpu_torch.graph.container import Graph
from mma_tpu_torch.nn import init as inits
from mma_tpu_torch.ops.spmm import binary_spmm
from mma_tpu_torch.parallel.collectives import AxisName
from mma_tpu_torch.utils.profiling import trace


class GraphConvolution(nn.Module):
    """Parameters ``w`` ``(in, out)`` and ``b`` ``(out,)``, as in the JAX package."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: str = "float32", *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype = compute_dtype
        self.edge_dtype = torch_compute_dtype(compute_dtype, dev)
        # pygcn init: stdv = 1/√weight.size(1) (layers.py:32-36).
        self.w = nn.Parameter(
            inits.uniform_fan_out((in_features, out_features), generator).to(dev))
        self.b = (nn.Parameter(
            inits.uniform((out_features,), out_features ** -0.5, generator).to(dev))
            if bias else None)

    def forward(self, x: torch.Tensor, graph: Graph, axis_name: AxisName = None
                ) -> torch.Tensor:
        with trace("gcn.layer"):
            out = binary_spmm(graph, (x @ self.w).to(self.edge_dtype), axis_name)
            if self.b is not None:
                out = out + self.b
            return out
