"""Node-table gathers whose VJPs are sorted segment sums.

``x[graph.dst]`` and ``x[graph.src]`` are plain ``index_select``s forward.
Their transposes are scatter-adds, which PyTorch runs on the card as an
atomic ``index_add_`` whose summation order changes run to run. These
Functions take kernel 1 instead, as the JAX package's ``ops/gather.py``
takes its Pallas segment sum:

- :func:`gather_by_dst`: a dst-keyed sum over ``Graph.real_row_ptr``;
- :func:`gather_by_src`: a src-keyed sum over ``Graph.real_col_ptr``,
  reading the edge rows through ``src_perm``;
- :func:`gather_rows`: a lookup ``table[idx]`` in a small table (the
  embeddings), whose VJP is a one-hot product.

Both reduce over the real edges only: padding edges get no gradient to
give, where the JAX package's XLA scatter lands it on the padding row.
Padding rows of the result are 0.
"""

from __future__ import annotations

import torch

from mma_tpu_torch.graph.container import Graph
from mma_tpu_torch.ops.cuda.fused_mma import segment_sum_csr


class _GatherByDst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dst, row_ptr):
        ctx.save_for_backward(row_ptr)
        return x.index_select(0, dst)

    @staticmethod
    def backward(ctx, ct):
        (row_ptr,) = ctx.saved_tensors
        return segment_sum_csr(ct.contiguous(), row_ptr), None, None


class _GatherBySrc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, col_ptr, src_perm):
        ctx.save_for_backward(col_ptr, src_perm)
        return x.index_select(0, src)

    @staticmethod
    def backward(ctx, ct):
        col_ptr, src_perm = ctx.saved_tensors
        return segment_sum_csr(ct.contiguous(), col_ptr, index=src_perm), None, None, None


def gather_by_dst(x: torch.Tensor, graph: Graph) -> torch.Tensor:
    """``x[graph.dst]`` (N, C) → (E, C); VJP = kernel 1 over the CSR."""
    return _GatherByDst.apply(x, graph.dst, graph.real_row_ptr)


def gather_by_src(x: torch.Tensor, graph: Graph) -> torch.Tensor:
    """``x[graph.src]`` (N, C) → (E, C); VJP = kernel 1 over the CSC."""
    if graph.csc_ell_exact:
        raise NotImplementedError("the degree-exact CSC reduce is not ported yet (ZINC)")
    return _GatherBySrc.apply(x, graph.src, graph.real_col_ptr, graph.src_perm)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        one_hot = torch.nn.functional.one_hot(idx, ctx.n_rows).to(ct.dtype)
        return one_hot.t() @ ct, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (R, C) → (len(idx), C) for a small table (the ZINC
    type embeddings: R = 21 and 4). Its VJP is the product
    ``one_hot(idx)ᵀ @ ct``, deterministic, where ``index_select``'s own VJP
    is an atomic ``index_add_``. (A segment sum over the sorted ids would
    leave one warp per table row: tens of milliseconds for the carbon row
    of a 1,024-molecule batch.)"""
    return _GatherRows.apply(table, idx.reshape(-1).long())
