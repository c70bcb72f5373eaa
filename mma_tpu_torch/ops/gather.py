"""Node-table gathers whose VJPs are sorted segment sums.

``x[graph.dst]`` and ``x[graph.src]`` are plain ``index_select``s forward.
Their transposes are scatter-adds, which PyTorch runs on the card as an
atomic ``index_add_`` whose summation order changes run to run. These
Functions take kernel 1 instead, as the JAX package's ``ops/gather.py``
takes its Pallas segment sum:

- :func:`gather_by_dst`: a dst-keyed sum over ``Graph.real_row_ptr``
  (:func:`gather_by_csr` over any sorted index and its CSR);
- :func:`gather_by_src`: a src-keyed sum over ``Graph.real_col_ptr``,
  reading the edge rows through ``src_perm``; on a graph whose CSC order
  is degree-exact (``Graph.csc_ell_exact``) a permute and per-bucket lane
  sums instead, with no kernel (the JAX package's
  ``_csc_exact_segment_sum``);
- a graph without the CSC fields (an edge shard built without kernel
  structure, ``mma_tpu_torch.parallel``) gets its CSC order derived on the
  device (:func:`csc_view`), where the JAX package falls back to an XLA
  scatter;
- :func:`gather_rows`: a lookup ``table[idx]`` in a small table (the
  embeddings), whose VJP is a one-hot product.

Both reduce over the real edges only: padding edges get no gradient to
give, where the JAX package's XLA scatter lands it on the padding row.
Padding rows of the result are 0. The sums are float32 and the gradient
comes back in ``x``'s dtype (a bf16 table's cotangent rows are summed by
kernel 1's bf16 form), as the JAX package's VJPs cast it.
"""

from __future__ import annotations

import torch

from mma_tpu_torch.graph.container import Graph
from mma_tpu_torch.ops.cuda.fused_mma import segment_sum_csr
from mma_tpu_torch.ops.ell import (
    EllSpec,
    _csc_order,
    ell_expand_exact,
    masked_slot_sum,
    pad_rows,
)


class _GatherByDst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dst, row_ptr):
        ctx.save_for_backward(row_ptr)
        ctx.dtype = x.dtype
        return x.index_select(0, dst)

    @staticmethod
    def backward(ctx, ct):
        (row_ptr,) = ctx.saved_tensors
        return segment_sum_csr(ct.contiguous(), row_ptr).to(ctx.dtype), None, None


class _GatherBySrc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, col_ptr, src_perm, exact_hint):
        ctx.save_for_backward(col_ptr, src_perm)
        ctx.exact_hint, ctx.n_node, ctx.dtype = exact_hint, x.shape[0], x.dtype
        return x.index_select(0, src)

    @staticmethod
    def backward(ctx, ct):
        col_ptr, src_perm = ctx.saved_tensors
        if ctx.exact_hint is not None:
            dx = _csc_exact_segment_sum(ct, src_perm, ctx.exact_hint, ctx.n_node)
        else:
            dx = segment_sum_csr(ct.contiguous(), col_ptr, index=src_perm)
        return dx.to(ctx.dtype), None, None, None, None


def _csc_exact_segment_sum(ct: torch.Tensor, src_perm: torch.Tensor, ell_hint,
                           n_node: int) -> torch.Tensor:
    """Src-keyed float32 segment sum on a symmetric degree-exact graph: after
    the CSC permute the edge stream is degree-exact under the same buckets
    (every bucket row has exactly its width in out-edges), so the sum is
    per-bucket lane-slice sums of a ``(rows, W·C)`` reshape, slot by slot
    in order. One permute gather, no kernel, no scatter. The rows past the
    buckets (degree-0 and padding rows) get 0."""
    spec = EllSpec.from_hint(ell_hint)
    blocks = ell_expand_exact(ct.index_select(0, src_perm.long()), spec)
    return pad_rows(torch.cat([masked_slot_sum(b, None, w) for b, w in zip(blocks, spec.widths)]),
                    n_node)


def gather_by_csr(x: torch.Tensor, dst: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """``x[dst]`` (N, C) → (E, C) for a sorted index ``dst`` whose CSR is
    ``row_ptr``; VJP = kernel 1 over ``row_ptr`` (edges it does not cover
    give nothing)."""
    return _GatherByDst.apply(x, dst, row_ptr)


def gather_by_dst(x: torch.Tensor, graph: Graph) -> torch.Tensor:
    """``x[graph.dst]`` (N, C) → (E, C); VJP = kernel 1 over the CSR."""
    return gather_by_csr(x, graph.dst, graph.real_row_ptr)


def csc_view(graph: Graph):
    """``(src_perm, real_col_ptr, dst_csc)``: the graph's CSC view over its
    real edges, or, for a graph that carries none, the same derived on its
    device (a stable argsort of ``src`` and a searchsorted, as
    ``finish_graph_on_device`` derives them)."""
    if graph.src_perm is not None:
        return graph.src_perm, graph.real_col_ptr, graph.dst_csc
    perm, col_ptr = _csc_order(graph)
    real_col_ptr = torch.cat([col_ptr[:-1], col_ptr[-2:-1]])
    return perm.to(torch.int32), real_col_ptr, graph.dst.index_select(0, perm)


def gather_by_src(x: torch.Tensor, graph: Graph) -> torch.Tensor:
    """``x[graph.src]`` (N, C) → (E, C); VJP = kernel 1 over the CSC, or
    lane sums when the CSC order is degree-exact."""
    src_perm, real_col_ptr, _ = csc_view(graph)
    return _GatherBySrc.apply(x, graph.src, real_col_ptr, src_perm,
                              graph.ell_hint if graph.csc_ell_exact else None)


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
