"""K-way masked aggregation, the core of the MMA layer.

For every center node ``i`` and neighbor ``j`` the reference computes
``mask_ij = act([h_i ‖ h_j] @ W_k)`` and sums ``mask_ij ⊙ h_j`` over ``j``.
As in the JAX package, ``[h_i ‖ h_j] @ W = h_i @ W_top + h_j @ W_bot``:
``c = h @ W_top`` is one per-node matmul for all K aggregators, and the
per-edge work (``h[src] @ W_bot``, the activation, the product with
``tile(h[src], K)`` and the sum over each destination's edges) runs in the
lean edge program (``mma_tpu_torch.ops.cuda.fused_mma.edge_program_lean``).
All K aggregators share one flat ``(N, K·F)`` layout; aggregator ``k``
owns lanes ``[k·F, (k+1)·F)``.

This module serves the eval forward. Mask dropout (N2) and the
``std``/``moment_3`` combines need per-edge messages and raise
``NotImplementedError`` until the training slice ports that path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mma_tpu_torch.graph.container import Graph
from mma_tpu_torch.ops.aggregators import AggSpec
from mma_tpu_torch.ops.cuda.fused_mma import edge_program_lean


def _flat_lanes(w: torch.Tensor) -> torch.Tensor:
    """``(K, F, F)`` per-aggregator blocks → ``(F, K·F)``, aggregator-major lanes."""
    k, f, _ = w.shape
    return w.permute(1, 0, 2).reshape(f, k * f)


def mma_mask_projections(h: torch.Tensor, mask_weights: torch.Tensor):
    """Per-node mask projections ``c, d``: each ``(N, K·F)`` flat.

    ``mask_weights``: ``(K, 2F, F)`` — one ``[W_top; W_bot]`` per
    aggregator. Per-edge logits are ``c[dst] + d[src]``.
    """
    f = mask_weights.shape[2]
    c = h @ _flat_lanes(mask_weights[:, :f, :])
    d = h @ _flat_lanes(mask_weights[:, f:, :])
    return c, d


def sigmoid_lane_pattern(specs: Sequence[AggSpec], activation: str,
                         parity: bool, f: int, device) -> torch.Tensor:
    """(K·F,) float 0/1: which flat lanes get the sigmoid (N1 table)."""
    pat = torch.tensor(
        [float(s.applies_sigmoid(activation, parity)) for s in specs],
        dtype=torch.float32,
    )
    return pat.repeat_interleave(f).to(device)


def masked_multi_aggregate(
    h: torch.Tensor,
    graph: Graph,
    mask_weights: torch.Tensor,
    specs: Sequence[AggSpec],
    *,
    activation: str = "new_sigmoid",
    parity: bool = True,
    mask_dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """K-way masked aggregation: returns ``(N, K, F)`` combined outputs.

    For each aggregator ``k``:
    ``S_k[i] = Σ_{e: dst(e)=i} act_k(logits_k[e]) ⊙ h[src(e)]``, then the
    spec's center combine. Rows of padding nodes are unspecified.
    ``generator`` with a positive ``mask_dropout_rate`` requests mask
    dropout, which is not ported yet.
    """
    n, f = h.shape
    k = len(specs)
    if mask_weights.shape != (k, 2 * f, f):
        raise ValueError(f"mask_weights {tuple(mask_weights.shape)} != {(k, 2 * f, f)}")
    if generator is not None and mask_dropout_rate > 0.0:
        raise NotImplementedError("mask dropout lands with the training slice")
    unported = sorted({s.combine for s in specs} & {"std", "moment_3"})
    if unported:
        raise NotImplementedError(f"combines {unported} land with the training slice")

    pat = sigmoid_lane_pattern(specs, activation, parity, f, h.device)
    w_top = _flat_lanes(mask_weights[:, :f, :])
    w_bot = _flat_lanes(mask_weights[:, f:, :]).contiguous()
    c = h @ w_top
    s = edge_program_lean(c, w_bot, h.contiguous(), pat, graph.src, graph.real_row_ptr)
    s = s.reshape(n, k, f)

    deg = torch.clamp(graph.deg, min=1.0)[:, None]  # (N, 1)
    outs = []
    for idx, sp in enumerate(specs):
        sk = s[:, idx, :]
        if sp.combine == "sum":
            out = h + sk
        elif sp.combine == "mean":
            out = (h + sk) / deg
        elif sp.combine == "max":
            out = torch.maximum(h, sk)
        elif sp.combine == "min":
            out = torch.minimum(h, sk)
        elif sp.combine == "passthrough":
            out = sk
        elif sp.combine == "normalized_mean":
            out = sk * torch.rsqrt(deg)
        else:
            raise ValueError(f"unknown combine {sp.combine!r}")
        outs.append(out)
    return torch.stack(outs, dim=1)  # (N, K, F)
