"""The port's segment-sum and lean edge-program functions against the JAX
package's Pallas kernels (interpret mode on the CPU) and XLA formulation.

The CPU runs the plain PyTorch versions; ``test_torch_cuda_kernels.py``
holds the CUDA kernels against them on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mma_tpu.graph.build import graph_from_edges as jax_graph_from_edges
from mma_tpu.ops.aggregators import get_agg_spec as jax_get_agg_spec
from mma_tpu.ops.masked_aggregate import (
    _sigmoid_lane_pattern as jax_lane_pattern,
    mma_mask_logits as jax_mask_logits,
    mma_mask_projections as jax_mask_projections,
)
from mma_tpu.ops.pallas.fused_mma import (
    fused_mma_edge_program_lean,
    fused_segment_sum,
)
from mma_tpu.ops.segment import segment_sum as jax_segment_sum

from mma_tpu_torch.graph import graph_from_edges
from mma_tpu_torch.ops import get_agg_spec, segment_sum
from mma_tpu_torch.ops.cuda import build, fused_mma
from mma_tpu_torch.ops.masked_aggregate import mma_mask_projections, sigmoid_lane_pattern


def _coo(n=300, n_edges=2400, isolated=40, seed=0):
    """Random COO whose last ``isolated`` nodes have no in-edges (empty rows)."""
    rs = np.random.RandomState(seed)
    src = rs.randint(0, n, n_edges).astype(np.int32)
    dst = rs.randint(0, n - isolated, n_edges).astype(np.int32)
    return src, dst, n


@pytest.fixture(scope="module")
def graphs():
    src, dst, n = _coo()
    return jax_graph_from_edges(src, dst, n), graph_from_edges(src, dst, n, device="cpu"), n


def _program_inputs(n_pad, f, k, seed=1):
    rs = np.random.RandomState(seed)
    h = rs.randn(n_pad, f).astype(np.float32)
    mw = (rs.randn(k, 2 * f, f) / np.sqrt(f)).astype(np.float32)
    w_top = mw[:, :f, :].transpose(1, 0, 2).reshape(f, k * f)
    w_bot = mw[:, f:, :].transpose(1, 0, 2).reshape(f, k * f)
    return h, mw, np.ascontiguousarray(h @ w_top), np.ascontiguousarray(w_bot)


@pytest.fixture(scope="module")
def hub_graphs():
    """300 nodes: node 0 takes a 3,000-edge row (the heavy row that the
    card's kernel splits across edge chunks), the last 40 no edges."""
    rs = np.random.RandomState(5)
    n = 300
    src = rs.randint(0, n, 5400).astype(np.int32)
    dst = np.concatenate([np.zeros(3000, np.int32), rs.randint(1, n - 40, 2400)]).astype(np.int32)
    return jax_graph_from_edges(src, dst, n), graph_from_edges(src, dst, n, device="cpu"), n


@pytest.fixture(scope="module")
def hub_src_graphs():
    """300 nodes: node 0 is the source of 3,000 edges (the heavy CSC column
    that the card's src pass splits across edge chunks), the last 40 take
    no edges."""
    rs = np.random.RandomState(6)
    n = 300
    src = np.concatenate([np.zeros(3000, np.int32), rs.randint(1, n, 2400)]).astype(np.int32)
    dst = rs.randint(0, n - 40, 5400).astype(np.int32)
    return jax_graph_from_edges(src, dst, n), graph_from_edges(src, dst, n, device="cpu"), n


@pytest.mark.parametrize("which", ["graphs", "hub_graphs"])
def test_segment_sum_reference_matches_pallas_kernel(request, which):
    jg, tg, _ = request.getfixturevalue(which)
    rs = np.random.RandomState(0)
    data = rs.randn(jg.n_edge, 32).astype(np.float32)
    data[~np.asarray(jg.edge_mask)] = 0.0
    want = np.asarray(fused_segment_sum(jnp.asarray(data), jg, precision="highest"))
    got = fused_mma.segment_sum_reference(torch.from_numpy(data), tg.row_ptr)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # Through the wrapper, CPU tensors take the same plain version.
    np.testing.assert_array_equal(
        fused_mma.segment_sum_csr(torch.from_numpy(data), tg.row_ptr).numpy(), got.numpy()
    )
    assert np.all(got.numpy()[260:300] == 0.0)  # empty rows give 0


def test_segment_sum_plain_matches_jax(graphs):
    jg, tg, _ = graphs
    rs = np.random.RandomState(2)
    data = rs.randn(jg.n_edge, 8).astype(np.float32)
    want = np.asarray(jax_segment_sum(jnp.asarray(data), jg.dst, jg.n_node))
    got = segment_sum(torch.from_numpy(data), tg.dst, tg.n_node)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", ["graphs", "hub_graphs"])
@pytest.mark.parametrize("aggs", [("mean", "mean2"), ("mean", "max")])
def test_edge_program_lean_reference_matches_jax(request, which, aggs):
    """Against the Pallas lean kernel (interpret, bf16-split "high") and the
    XLA formulation; ("mean", "max") mixes sigmoid and raw-logit lanes.
    ``hub_graphs`` puts 3,000 edges in one row, which the card's edge pass
    splits across chunks."""
    jg, tg, n = request.getfixturevalue(which)
    f, k = 16, len(aggs)
    h, mw, c, w_bot = _program_inputs(jg.n_node, f, k)
    jspecs = [jax_get_agg_spec(a) for a in aggs]
    jpat = jax_lane_pattern(jspecs, "new_sigmoid", True, f)
    pat = sigmoid_lane_pattern([get_agg_spec(a) for a in aggs], "new_sigmoid", True, f, "cpu")
    np.testing.assert_array_equal(pat.numpy(), np.asarray(jpat, np.float32))

    got = fused_mma.edge_program_lean(
        torch.from_numpy(c), torch.from_numpy(w_bot), torch.from_numpy(h), pat,
        tg.src, tg.row_ptr, tg.col_ptr, tg.dst_csc,
    ).numpy()

    pallas = np.asarray(fused_mma_edge_program_lean(
        jnp.asarray(c), jnp.asarray(w_bot), jnp.asarray(h), jpat, jg, k))
    np.testing.assert_allclose(got[:n], pallas[:n], rtol=2e-3, atol=2e-3)

    logits = jax_mask_logits(jnp.asarray(h), jnp.asarray(mw), jg)
    mask = jnp.where(jpat[None, :], jax.nn.sigmoid(logits), logits)
    msgs = mask * jnp.tile(jnp.asarray(h)[jg.src], (1, k))
    msgs = jnp.where(jg.edge_mask[:, None], msgs, 0.0)
    xla = np.asarray(jax_segment_sum(msgs, jg.dst, jg.n_node))
    np.testing.assert_allclose(got[:n], xla[:n], rtol=1e-5, atol=1e-5)
    assert np.all(got[260:n] == 0.0)  # empty rows give 0


@pytest.mark.parametrize("which", ["graphs", "hub_graphs", "hub_src_graphs"])
def test_edge_program_lean_bwd_reference_matches_jax(request, which):
    """``edge_program_lean_bwd_reference``'s ``(dc, dW_bot, dh)`` against
    ``jax.vjp`` of the Pallas lean program with respect to ``(c, W_bot,
    h)`` (``_program_bwd_lean_kernel`` in interpret mode, bf16-split
    "high": 2e-3) and ``jax.grad`` of the XLA formulation (1e-5), on the
    mixed sigmoid / raw lanes of ("mean", "max"). ``hub_graphs`` has a
    3,000-edge destination row, ``hub_src_graphs`` a 3,000-edge source,
    the rows the card's dst and src passes split across chunks. Each
    tolerance is relative, with a floor of the same fraction of the
    output's largest value: a 3,000-term f32 sum taken in another order
    differs by a few ulps of its largest partial sums."""
    jg, tg, n = request.getfixturevalue(which)
    aggs, f = ("mean", "max"), 16
    k = len(aggs)
    h, _, c, w_bot = _program_inputs(jg.n_node, f, k)
    ct = np.random.RandomState(2).randn(jg.n_node, k * f).astype(np.float32)
    ct[n:] = 0.0  # padding rows: the Pallas forward sums the padding edges there
    jpat = jax_lane_pattern([jax_get_agg_spec(a) for a in aggs], "new_sigmoid", True, f)
    pat = sigmoid_lane_pattern([get_agg_spec(a) for a in aggs], "new_sigmoid", True, f, "cpu")
    args = (torch.from_numpy(c), torch.from_numpy(w_bot), torch.from_numpy(h), pat, tg.src,
            tg.real_row_ptr, tg.real_col_ptr, tg.dst_csc, torch.from_numpy(ct))
    got = [t.numpy() for t in fused_mma.edge_program_lean_bwd_reference(*args)]
    # Through the wrapper, CPU tensors take the same plain version.
    for a, b in zip(fused_mma.edge_program_lean_bwd(*args), got):
        np.testing.assert_array_equal(a.numpy(), b)
    jargs = (jnp.asarray(c), jnp.asarray(w_bot), jnp.asarray(h))

    _, vjp = jax.vjp(lambda c_, w_, h_: fused_mma_edge_program_lean(c_, w_, h_, jpat, jg, k),
                     *jargs)
    pallas = [np.asarray(g) for g in vjp(jnp.asarray(ct))]

    def xla(c_, w_, h_):
        h_src = h_[jg.src]
        logits = c_[jg.dst] + h_src @ w_
        msgs = jnp.where(jpat[None, :], jax.nn.sigmoid(logits), logits) * jnp.tile(h_src, (1, k))
        msgs = jnp.where(jg.edge_mask[:, None], msgs, 0.0)
        return jnp.sum(jax_segment_sum(msgs, jg.dst, jg.n_node) * jnp.asarray(ct))

    exact = [np.asarray(g) for g in jax.grad(xla, argnums=(0, 1, 2))(*jargs)]
    for want, tol in ((pallas, 2e-3), (exact, 1e-5)):
        for name, g, w in zip(("dc", "dW_bot", "dh"), got, want):
            rows = slice(None) if name == "dW_bot" else slice(0, n)
            np.testing.assert_allclose(g[rows], w[rows], rtol=tol,
                                       atol=tol * np.abs(w[rows]).max(), err_msg=name)


def test_mask_projections_match_jax():
    h, mw, _, _ = _program_inputs(24, 8, 3)
    jc, jd = jax_mask_projections(jnp.asarray(h), jnp.asarray(mw))
    c, d = mma_mask_projections(torch.from_numpy(h), torch.from_numpy(mw))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)


def test_kernel_path_raises_off_the_card_and_counts_nothing():
    before = dict(fused_mma.LAUNCHES)
    data = torch.zeros(8, 4, device="meta")
    row_ptr = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_mma.segment_sum_csr(data, row_ptr)
    h = torch.zeros(2, 4, device="meta")
    args = (torch.zeros(2, 8, device="meta"), torch.zeros(4, 8, device="meta"), h,
            torch.zeros(8, device="meta"), torch.zeros(8, dtype=torch.int32, device="meta"),
            row_ptr)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_mma.edge_program_lean(*args, row_ptr, args[4])
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_mma.edge_program_lean_bwd(*args, row_ptr, args[4],
                                        torch.zeros(2, 8, device="meta"))
    # Inputs that require grad take the same route, through the autograd
    # Functions; the indexed form is backward machinery and refuses them.
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_mma.segment_sum_csr(data.requires_grad_(), row_ptr)
    with pytest.raises(ValueError, match="not differentiable"):
        fused_mma.segment_sum_csr(data, row_ptr, index=torch.zeros(8, dtype=torch.int32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            build.library("fused_mma")
    assert fused_mma.LAUNCHES == before
