"""Sparse × dense products over binary adjacencies.

The reference's two SpMM sites (``node_classification/layers.py:41,862``)
multiply the raw 0/1 adjacency (no normalization, no self-loops) by dense
features. Over the dst-sorted edge list that is one sorted segment sum of
the source rows: ``out[i] = Σ_{j ∈ N(i)} x[j]``, which kernel 1 reads
through the ``src`` index. The transpose is the same sum over the CSC:
``dx[j] = Σ_{i: j ∈ N(i)} ct[i]``, read through ``dst_csc``. Neither
direction uses atomics.

A bf16 ``x`` (the edge pipeline's ``compute_dtype="bfloat16"``) is summed
in float32 by kernel 1's bf16 form, and its gradient, a float32 sum over
the CSC, comes back as bf16, as in the JAX package
(``mma_tpu/ops/spmm.py:95-131``).

A degree-bounded graph that carries an ELL layout (``Graph.ell_hint``, the
sampler's hopped layout) and no CSC view takes the JAX package's ELL branch
(``mma_tpu/ops/spmm.py:33-56``): per-slot source rows, masked slot sums. A
graph that keeps its CSC takes kernel 1 both ways, as there: the JAX
package measured the CSR product faster for a plain SpMM.

``axis_name`` (a mesh axis's process group; ``mma_tpu_torch.parallel``)
runs the product on an edge shard: each rank sums its shard's edges into a
full-size partial and :func:`~mma_tpu_torch.parallel.collectives.psum`
combines them (``mma_tpu/ops/spmm.py:129-130``, ``:140-141``), with the
ELL branch off (``:34``). A shard without a CSC derives it on the device
for the backward (:func:`~mma_tpu_torch.ops.gather.csc_view`).
"""

from __future__ import annotations

import torch

from mma_tpu_torch.graph.container import Graph
from mma_tpu_torch.ops.cuda.fused_mma import segment_sum_csr
from mma_tpu_torch.ops.ell import (
    EllSpec,
    ell_gather_nodes_by_src,
    ell_valid,
    masked_slot_sum,
    pad_rows,
)
from mma_tpu_torch.ops.gather import csc_view
from mma_tpu_torch.parallel.collectives import AxisName, psum


class _BinarySpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, row_ptr, dst_csc, col_ptr):
        ctx.save_for_backward(dst_csc, col_ptr)
        ctx.dtype = x.dtype
        return segment_sum_csr(x, row_ptr, index=src)

    @staticmethod
    def backward(ctx, ct):
        dst_csc, col_ptr = ctx.saved_tensors
        dx = segment_sum_csr(ct.contiguous(), col_ptr, index=dst_csc).to(ctx.dtype)
        return dx, None, None, None, None


def binary_spmm(graph: Graph, x: torch.Tensor, axis_name: AxisName = None) -> torch.Tensor:
    """``A @ x`` for the graph's binary adjacency; ``x`` is ``(N, F)``
    float32 or bf16.

    Both directions reduce over the real edges only
    (``Graph.real_row_ptr`` / ``Graph.real_col_ptr``), and no real edge
    touches a padding node, so padding rows of ``x`` (whatever they hold)
    never reach a real row, and padding rows of the result and of the
    gradient are 0. Returns ``(N, F)`` float32.

    An ELL graph without a CSC (module docstring) sums each row's valid
    slots in slot order; the gradient is the slot gather's VJP, kernel 1
    over a CSC order derived on the device.
    """
    if (axis_name is None and graph.ell_hint is not None and not graph.ell_exact
            and graph.src_perm is None):
        spec = EllSpec.from_hint(graph.ell_hint)
        parts = ell_gather_nodes_by_src(x, graph, spec)
        sums = [masked_slot_sum(p, v, w)
                for p, v, w in zip(parts, ell_valid(graph, spec), spec.widths)]
        return pad_rows(torch.cat(sums, dim=0), graph.n_node)
    _, real_col_ptr, dst_csc = csc_view(graph)
    out = _BinarySpmm.apply(x.contiguous(), graph.src, graph.real_row_ptr, dst_csc,
                            real_col_ptr)
    return psum(out, axis_name)
