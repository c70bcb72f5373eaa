"""Sparse × dense products over binary adjacencies.

The reference's two SpMM sites (``node_classification/layers.py:41,862``)
multiply the raw 0/1 adjacency (no normalization, no self-loops) by dense
features. Over the dst-sorted edge list that is one sorted segment sum of
the source rows: ``out[i] = Σ_{j ∈ N(i)} x[j]``, which kernel 1 reads
through the ``src`` index. The transpose is the same sum over the CSC:
``dx[j] = Σ_{i: j ∈ N(i)} ct[i]``, read through ``dst_csc``. Neither
direction uses atomics.
"""

from __future__ import annotations

import torch

from mma_tpu_torch.graph.container import Graph
from mma_tpu_torch.ops.cuda.fused_mma import segment_sum_csr


class _BinarySpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, row_ptr, dst_csc, col_ptr):
        ctx.save_for_backward(dst_csc, col_ptr)
        return segment_sum_csr(x, row_ptr, index=src)

    @staticmethod
    def backward(ctx, ct):
        dst_csc, col_ptr = ctx.saved_tensors
        return segment_sum_csr(ct.contiguous(), col_ptr, index=dst_csc), None, None, None, None


def binary_spmm(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for the graph's binary adjacency; ``x`` is ``(N, F)``.

    Both directions reduce over the real edges only
    (``Graph.real_row_ptr`` / ``Graph.real_col_ptr``), and no real edge
    touches a padding node, so padding rows of ``x`` (whatever they hold)
    never reach a real row, and padding rows of the result and of the
    gradient are 0. Returns ``(N, F)`` float32.
    """
    return _BinarySpmm.apply(x.contiguous(), graph.src, graph.real_row_ptr,
                             graph.dst_csc, graph.real_col_ptr)
