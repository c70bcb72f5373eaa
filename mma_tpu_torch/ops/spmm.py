"""Sparse × dense products over binary adjacencies.

The reference's two SpMM sites (``node_classification/layers.py:41,862``)
multiply the raw 0/1 adjacency (no normalization, no self-loops) by dense
features. Over the dst-sorted edge list that is one gather and one sorted
segment sum: ``out[i] = Σ_{j ∈ N(i)} x[j]``.
"""

from __future__ import annotations

import torch

from mma_tpu_torch.graph.container import Graph
from mma_tpu_torch.ops.cuda.fused_mma import segment_sum_csr


def binary_spmm(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for the graph's binary adjacency; ``x`` is ``(N, F)``.

    The reduction runs over ``Graph.real_row_ptr``, which skips the padding
    edges, and no real edge has a padding node as its source, so padding
    rows of ``x`` (whatever they hold) never reach a real row. Returns
    ``(N, F)`` float32; padding rows are 0.
    """
    return segment_sum_csr(x.index_select(0, graph.src), graph.real_row_ptr)
