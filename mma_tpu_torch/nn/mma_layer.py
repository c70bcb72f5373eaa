"""The node-classification MMA layer.

The reference's concat-then-tile algebra (``layers.py:855-865``)
collapses, by linearity of the scalers and the shared W, to

    out = A @ ( (Σ_s scale_s)(Σ_k aggregate_k(H)) @ W ) + b

which is what this layer computes: one K-way masked aggregation, the
scaler stage, one dense projection and one SpMM. Only the selected
aggregators' masks are allocated (N10).

``compute_dtype`` (``"float32"``, ``"bfloat16"`` or ``"auto"``, resolved by
:func:`mma_tpu_torch.autotune.resolve_compute_dtype` on the layer's device)
is the edge pipeline's dtype: the masked aggregation's operands and the
SpMM operand ``scaled @ W``, cast after the float32 product. Parameters,
sums and the output stay float32.

``axis_name`` runs the layer's edge-driven reductions on an edge shard, as
the JAX package's ``mma_tpu/nn/mma_layer.py:98-130`` (see
``mma_tpu_torch.parallel.edge_parallel``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mma_tpu_torch.autotune import torch_compute_dtype
from mma_tpu_torch.device import DeviceLike, resolve_device
from mma_tpu_torch.graph.container import Graph
from mma_tpu_torch.nn import init as inits
from mma_tpu_torch.ops.aggregators import get_agg_spec
from mma_tpu_torch.ops.masked_aggregate import masked_multi_aggregate
from mma_tpu_torch.ops.scalers import SCALER_NAMES, apply_scalers
from mma_tpu_torch.ops.spmm import binary_spmm
from mma_tpu_torch.parallel.collectives import AxisName
from mma_tpu_torch.utils.profiling import trace


class MMALayer(nn.Module):
    """Parameters ``w`` ``(in, out)``, ``masks`` ``(K, 2·in, in)`` and
    ``b`` ``(out,)``, as in the JAX package."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        aggregators: Sequence[str],
        scalers: Sequence[str] = SCALER_NAMES,
        activation: str = "new_sigmoid",
        sigmoid_k: float = 2.0,  # reference --k; inert (its branch is dead, N1)
        mask_dropout: float = 0.5,
        parity: bool = True,
        bias: bool = True,
        compute_dtype: str = "float32",
        *,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        self.aggregators = tuple(aggregators)
        self.scalers = tuple(scalers)
        self.activation = activation
        self.sigmoid_k = sigmoid_k
        self.mask_dropout = mask_dropout
        self.parity = parity
        self.compute_dtype = compute_dtype
        self.edge_dtype = torch_compute_dtype(compute_dtype, dev)
        self.specs = tuple(get_agg_spec(a) for a in self.aggregators)
        if parity:
            for s in self.specs:
                if not s.reference_usable:
                    raise ValueError(
                        f"aggregator {s.name!r} is unusable in the reference "
                        "(crashes — N5); it exists only with parity=False"
                    )
        f_in, k = in_features, len(self.aggregators)
        bound = f_in ** -0.5
        self.w = nn.Parameter(inits.uniform((f_in, out_features), bound, generator).to(dev))
        self.masks = nn.Parameter(inits.uniform((k, 2 * f_in, f_in), bound, generator).to(dev))
        self.b = (nn.Parameter(inits.uniform((out_features,), bound, generator).to(dev))
                  if bias else None)

    def forward(self, h: torch.Tensor, graph: Graph, *,
                generator: Optional[torch.Generator] = None,
                axis_name: AxisName = None) -> torch.Tensor:
        """``generator`` turns on mask dropout (N2), drawn from it; ``None``
        gives the deterministic eval output."""
        with trace("mma.layer"):
            m = masked_multi_aggregate(
                h, graph, self.masks, self.specs,
                activation=self.activation, parity=self.parity,
                mask_dropout_rate=self.mask_dropout, generator=generator,
                compute_dtype=self.edge_dtype, axis_name=axis_name,
            )  # (N, K, F)
            scaled = apply_scalers(
                m.sum(dim=1), graph.deg, graph.node_mask, self.scalers, parity=self.parity
            )
            out = binary_spmm(graph, (scaled @ self.w).to(self.edge_dtype), axis_name)
            if self.b is not None:
                out = out + self.b
            return out
