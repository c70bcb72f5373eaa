"""The port's sum-of-squares reduction (kernel 8's plain version and its
autograd Function) against the JAX package's ``fused_segment_sum_sq``
(Pallas, interpret mode, ``precision="highest"``), on the CPU.

Tolerance 1e-5 relative and absolute: f32 sums of the same terms, taken
in another order on the JAX side.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mma_tpu.graph.build import graph_from_edges as jax_graph_from_edges
from mma_tpu.ops.pallas.fused_mma import fused_segment_sum_sq

from mma_tpu_torch.graph import graph_from_edges
from mma_tpu_torch.ops.cuda import fused_mma


@pytest.fixture(scope="module")
def graphs():
    """300 nodes, the last 40 without in-edges; padding edges at the tail."""
    rs = np.random.RandomState(0)
    n = 300
    src = rs.randint(0, n, 2400).astype(np.int32)
    dst = rs.randint(0, n - 40, 2400).astype(np.int32)
    return jax_graph_from_edges(src, dst, n), graph_from_edges(src, dst, n, device="cpu"), n


@pytest.mark.parametrize("channels", [16, 37])
def test_segment_sum_sq_matches_jax(graphs, channels):
    """Forward and VJP; padding edges carry data, which the port's CSR
    (``real_row_ptr``) skips and the JAX package masks."""
    jg, tg, n = graphs
    rs = np.random.RandomState(channels)
    data = rs.randn(jg.n_edge, channels).astype(np.float32)
    ct = rs.randn(jg.n_node, 2 * channels).astype(np.float32)
    e_mask = np.asarray(jg.edge_mask)
    assert not e_mask.all()

    def jloss(x):
        out = fused_segment_sum_sq(jnp.where(jg.edge_mask[:, None], x, 0.0), jg,
                                   precision="highest")
        return jnp.sum(out * ct), out

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(data))
    x = torch.from_numpy(data).requires_grad_()
    before = dict(fused_mma.LAUNCHES)
    got = fused_mma.segment_sum_sq_csr(x, tg.real_row_ptr)
    (got * torch.from_numpy(ct)).sum().backward()
    assert fused_mma.LAUNCHES == before  # the plain version on the CPU
    got = got.detach().numpy()
    assert got.shape == (tg.n_node, 2 * channels)
    np.testing.assert_allclose(got[:n], np.asarray(want)[:n], rtol=1e-5, atol=1e-5)
    assert not got[260:].any()  # rows without edges, and the padding node
    grad = x.grad.numpy()
    np.testing.assert_allclose(grad, np.asarray(jgrad), rtol=1e-5, atol=1e-5)
    assert not grad[~e_mask].any()  # padding edges


def test_segment_sum_sq_reference_sums_in_csr_order(graphs):
    """Each row is summed edge after edge in CSR order, the square rounded
    before it is added: equal bit for bit to that loop in float32, which is
    the kernel's order."""
    _, tg, _ = graphs
    rs = np.random.RandomState(3)
    data = (rs.randn(tg.n_edge, 5) * 10).astype(np.float32)
    rp = tg.real_row_ptr.numpy()
    want = np.zeros((tg.n_node, 10), np.float32)
    for i in range(tg.n_node):
        for e in range(rp[i], rp[i + 1]):
            x = data[e]
            want[i, :5] = want[i, :5] + x
            want[i, 5:] = want[i, 5:] + x * x
    got = fused_mma.segment_sum_sq_reference(torch.from_numpy(data), tg.real_row_ptr)
    np.testing.assert_array_equal(got.numpy(), want)
