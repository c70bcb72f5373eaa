"""The serving path's kernels as ``torch.library`` operators
(``mma_tpu_torch.ops.cuda.library``): ``torch.library.opcheck`` on each,
on the CPU (schema, fake implementation, autograd registration, AOT
dispatch with dynamic shapes), and each operator against its plain version.
"""

import numpy as np
import pytest
import torch

from mma_tpu_torch.graph import graph_from_edges
from mma_tpu_torch.ops.cuda import fused_mma
from mma_tpu_torch.ops.cuda import segment_minmax as mm

OPS = torch.ops.mma_tpu_torch


@pytest.fixture(scope="module")
def graph():
    """60 nodes, 400 edges, the last 10 nodes without in-edges."""
    rs = np.random.RandomState(0)
    src = rs.randint(0, 60, 400).astype(np.int32)
    dst = rs.randint(0, 50, 400).astype(np.int32)
    return graph_from_edges(src, dst, 60, device="cpu")


def _cases(graph):
    """``(operator, args, plain version)`` per case: kernel 1 with and
    without an index, f32 and bf16 rows; kernel 2 with f32 and bf16 ``h``;
    kernels 4 and 6 for one and two ops, 6 with and without a dropout seed;
    kernel 8."""
    rs = np.random.RandomState(1)
    n, e = graph.n_node, graph.n_edge
    rp = graph.real_row_ptr

    def t(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32))

    f, kf = 8, 16
    pat = torch.tensor([1.0] * f + [0.0] * f)
    lean = (t(n, kf), t(f, kf), t(n, f), pat, graph.src, rp)
    seed = torch.tensor([12345], dtype=torch.int32)
    return [
        ("segment_sum_csr", (t(e, 7), rp), fused_mma.segment_sum_reference),
        ("segment_sum_csr", (t(e, 8).bfloat16(), rp), fused_mma.segment_sum_reference),
        ("segment_sum_csr", (t(n, 5), rp, graph.src), fused_mma.segment_sum_reference),
        ("segment_sum_csr", (t(n, 4).bfloat16(), graph.real_col_ptr, graph.dst_csc),
         fused_mma.segment_sum_reference),
        ("edge_program_lean", lean, fused_mma.edge_program_lean_reference),
        ("edge_program_lean", lean[:2] + (lean[2].bfloat16(),) + lean[3:],
         fused_mma.edge_program_lean_reference),
        ("segment_minmax", (t(e, 6), rp, ["min", "max"]), mm.segment_minmax_reference),
        ("segment_minmax", (t(e, 6), rp, ["max"]), mm.segment_minmax_reference),
        ("minmax_edge_program", (t(n, 6), t(e, 6), rp, ["min", "max"], None, 0.5),
         mm.minmax_edge_program_reference),
        ("minmax_edge_program", (t(n, 6), t(e, 6), rp, ["max"], seed, 0.5),
         mm.minmax_edge_program_reference),
        ("segment_sum_sq_csr", (t(e, 5), rp), fused_mma.segment_sum_sq_reference),
    ]


@pytest.mark.parametrize("case", range(11))
def test_opcheck(graph, case):
    name, args, plain = _cases(graph)[case]
    torch.library.opcheck(getattr(OPS, name).default, args)
    got = getattr(OPS, name)(*args)
    assert got.dtype == torch.float32 and torch.equal(got, plain(*args))


def test_other_devices_raise(graph):
    """The wrappers refuse a meta tensor (the operator's fake implementation
    would answer it), and the operator has no implementation for a sparse
    one."""
    rp = graph.real_row_ptr.to("meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_mma.segment_sum_csr(torch.zeros(graph.n_edge, 4, device="meta"), rp)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mm.segment_minmax(torch.zeros(graph.n_edge, 4, device="meta"), rp, ("min",))
    out = OPS.segment_sum_csr(torch.zeros(graph.n_edge, 4, device="meta"), rp)  # the fake
    assert out.shape == (graph.n_node, 4) and out.device.type == "meta"
    with pytest.raises(NotImplementedError):
        OPS.segment_sum_csr(torch.zeros(2, 4).to_sparse(), graph.real_row_ptr)
