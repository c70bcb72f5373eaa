"""Gradients of the port's differentiable kernels' Functions against the JAX
package, on the CPU (where the Functions run the plain forward and the
plain backward).

Tolerances: 1e-5 where both sides are f32 sums of the same terms in
another order; 1e-4 against the XLA path through a whole aggregation (the
error of a few chained f32 products); 2e-3 against the Pallas kernels in
interpret mode, whose "high" precision splits f32 operands into bf16
terms (as in ``tests/test_torch_node_classifier.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mma_tpu.graph.build import graph_from_edges as jax_graph_from_edges
from mma_tpu.ops.aggregators import get_agg_spec as jax_get_agg_spec
from mma_tpu.ops.gather import gather_by_dst as jax_gather_by_dst
from mma_tpu.ops.gather import gather_by_src as jax_gather_by_src
from mma_tpu.ops.masked_aggregate import (
    _sigmoid_lane_pattern as jax_lane_pattern,
    masked_multi_aggregate as jax_masked_multi_aggregate,
)
from mma_tpu.ops.pallas.fused_mma import fused_mma_edge_program_lean
from mma_tpu.ops.spmm import binary_spmm as jax_binary_spmm

from mma_tpu_torch import MMALayer, NodeClassifier, graph_from_edges
from mma_tpu_torch.ops import binary_spmm, get_agg_spec, masked_multi_aggregate
from mma_tpu_torch.ops.cuda import fused_mma
from mma_tpu_torch.ops.gather import gather_by_dst, gather_by_src
from mma_tpu_torch.ops.masked_aggregate import sigmoid_lane_pattern


@pytest.fixture(scope="module")
def graphs():
    """N=200 with duplicate edges, 20 nodes without in-edges and 10 isolated."""
    rs = np.random.RandomState(0)
    n = 200
    src = rs.randint(0, n - 10, 1500).astype(np.int32)
    dst = rs.randint(0, n - 20, 1500).astype(np.int32)
    src = np.concatenate([src, src[:100]])
    dst = np.concatenate([dst, dst[:100]])
    return jax_graph_from_edges(src, dst, n), graph_from_edges(src, dst, n, device="cpu"), n


@pytest.fixture(scope="module")
def hub_graphs():
    """300 nodes: node 0 takes a 3,000-edge row (the heavy row that the
    card's kernels split across edge chunks), the last 40 no edges."""
    rs = np.random.RandomState(5)
    n = 300
    src = rs.randint(0, n, 5400).astype(np.int32)
    dst = np.concatenate([np.zeros(3000, np.int32), rs.randint(1, n - 40, 2400)]).astype(np.int32)
    return jax_graph_from_edges(src, dst, n), graph_from_edges(src, dst, n, device="cpu"), n


def _leaf(a):
    return torch.tensor(np.asarray(a), requires_grad=True)


def _program_inputs(n_pad, f, k, seed=1):
    rs = np.random.RandomState(seed)
    h = rs.randn(n_pad, f).astype(np.float32)
    mw = (rs.randn(k, 2 * f, f) / np.sqrt(f)).astype(np.float32)
    w_top = mw[:, :f, :].transpose(1, 0, 2).reshape(f, k * f)
    w_bot = mw[:, f:, :].transpose(1, 0, 2).reshape(f, k * f)
    ct = rs.randn(n_pad, k * f).astype(np.float32)
    return h, mw, np.ascontiguousarray(h @ w_top), np.ascontiguousarray(w_bot), ct


@pytest.mark.parametrize("which", ["graphs", "hub_graphs"])
@pytest.mark.parametrize("aggs", [("mean", "mean2"), ("mean", "max")])
def test_edge_program_lean_grads_match_pallas(request, which, aggs):
    """The Function (plain forward, plain kernel-3 backward, by-src reduce)
    against ``jax.vjp`` of the Pallas lean program (interpret mode), also
    over a 3,000-edge row (``hub_graphs``)."""
    jg, tg, n = request.getfixturevalue(which)
    f, k = 16, len(aggs)
    h, _, c, w_bot, ct = _program_inputs(jg.n_node, f, k)
    ct[n:] = 0.0  # padding rows: the Pallas forward sums padding edges there
    pat = sigmoid_lane_pattern([get_agg_spec(a) for a in aggs], "new_sigmoid", True, f, "cpu")
    jpat = jax_lane_pattern([jax_get_agg_spec(a) for a in aggs], "new_sigmoid", True, f)

    tc, tw, th = _leaf(c), _leaf(w_bot), _leaf(h)
    s = fused_mma.edge_program_lean(tc, tw, th, pat, tg.src, tg.real_row_ptr,
                                    tg.real_col_ptr, tg.dst_csc)
    s.backward(torch.from_numpy(ct))

    _, vjp = jax.vjp(
        lambda c_, w_, h_: fused_mma_edge_program_lean(c_, w_, h_, jpat, jg, k),
        jnp.asarray(c), jnp.asarray(w_bot), jnp.asarray(h))
    jdc, jdw, jdh = (np.asarray(g) for g in vjp(jnp.asarray(ct)))
    tol = dict(rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tc.grad.numpy()[:n], jdc[:n], **tol)
    np.testing.assert_allclose(tw.grad.numpy(), jdw, rtol=2e-3, atol=2e-3 * np.abs(jdw).max())
    np.testing.assert_allclose(th.grad.numpy()[:n], jdh[:n], **tol)


@pytest.mark.parametrize("aggs", [("mean", "mean2"), ("mean", "max")])
def test_fused_aggregate_grads_match_xla(graphs, aggs):
    """Through ``masked_multi_aggregate``'s fused lean route against
    ``jax.grad`` of the JAX package's XLA path."""
    jg, tg, n = graphs
    f, k = 16, len(aggs)
    h, mw, _, _, _ = _program_inputs(jg.n_node, f, k, seed=2)
    g = np.random.RandomState(3).randn(jg.n_node, k, f).astype(np.float32)
    g[n:] = 0.0
    jspecs = [jax_get_agg_spec(a) for a in aggs]

    def jloss(h_, mw_):
        out = jax_masked_multi_aggregate(h_, jg, mw_, jspecs, use_pallas=False)
        return jnp.sum(out * g)

    jdh, jdmw = (np.asarray(x) for x in jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h),
                                                                         jnp.asarray(mw)))
    th, tmw = _leaf(h), _leaf(mw)
    out = masked_multi_aggregate(th, tg, tmw, [get_agg_spec(a) for a in aggs])
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(th.grad.numpy()[:n], jdh[:n], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tmw.grad.numpy(), jdmw, rtol=1e-4,
                               atol=1e-4 * np.abs(jdmw).max())


def test_edge_program_lean_bwd_reference_matches_autograd(graphs):
    """The per-edge form (``edge_program_lean_payload_reference``, the JAX
    kernel's contract): ``dc``/``dW``/``payload`` against torch autograd of
    the plain forward; ``payload`` is the gradient of the edge's own
    gathered ``h[src]`` row."""
    _, tg, n = graphs
    f, k = 8, 3
    h, _, c, w_bot, ct = _program_inputs(tg.n_node, f, k, seed=4)
    pat = sigmoid_lane_pattern([get_agg_spec(a) for a in ("mean", "max", "sum")],
                               "new_sigmoid", True, f, "cpu")
    row_ptr = tg.real_row_ptr
    hi = int(row_ptr[-1])
    dc, dw, payload = fused_mma.edge_program_lean_payload_reference(
        torch.from_numpy(c), torch.from_numpy(w_bot), torch.from_numpy(h), pat, tg.src,
        row_ptr, torch.from_numpy(ct))

    tc, tw = _leaf(c), _leaf(w_bot)
    h_src = torch.tensor(h[tg.src[:hi].numpy()], requires_grad=True)  # one leaf row per edge
    ids = tg.dst[:hi].long()
    logits = tc[ids] + h_src @ tw
    msg = torch.where(pat.bool(), torch.sigmoid(logits), logits) * h_src.repeat(1, k)
    s = torch.zeros(tg.n_node, k * f).index_add(0, ids, msg)
    s.backward(torch.from_numpy(ct))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dc.numpy(), tc.grad.numpy(), **tol)
    np.testing.assert_allclose(dw.numpy(), tw.grad.numpy(), rtol=1e-5,
                               atol=1e-5 * tw.grad.abs().max().item())
    np.testing.assert_allclose(payload[:hi].numpy(), h_src.grad.numpy(), **tol)
    assert (payload[hi:] == 0).all()  # padding edges


@pytest.mark.parametrize("aggs", [("mean", "max", "sum"), ("mean", "mean2")])
def test_edge_program_lean_bwd_reference_dh_matches_autograd(graphs, aggs):
    """``edge_program_lean_bwd_reference``'s ``(dc, dW_bot, dh)`` against
    torch autograd of the plain forward with a leaf ``h``: ``dh`` is the
    gradient of both uses of ``h`` (the logits and the tiled message),
    which the per-edge payload summed by source must give; padding rows
    get none."""
    _, tg, n = graphs
    f, k = 8, len(aggs)
    h, _, c, w_bot, ct = _program_inputs(tg.n_node, f, k, seed=6)
    pat = sigmoid_lane_pattern([get_agg_spec(a) for a in aggs], "new_sigmoid", True, f, "cpu")
    row_ptr, col_ptr = tg.real_row_ptr, tg.real_col_ptr
    dc, dw, dh = fused_mma.edge_program_lean_bwd_reference(
        torch.from_numpy(c), torch.from_numpy(w_bot), torch.from_numpy(h), pat, tg.src,
        row_ptr, col_ptr, tg.dst_csc, torch.from_numpy(ct))

    tc, tw, th = _leaf(c), _leaf(w_bot), _leaf(h)
    fused_mma.edge_program_lean_reference(tc, tw, th, pat, tg.src, row_ptr).backward(
        torch.from_numpy(ct))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dc.numpy(), tc.grad.numpy(), **tol)
    np.testing.assert_allclose(dw.numpy(), tw.grad.numpy(), rtol=1e-5,
                               atol=1e-5 * tw.grad.abs().max().item())
    np.testing.assert_allclose(dh.numpy(), th.grad.numpy(), **tol)
    assert (dh[n:] == 0).all()  # no real edge leaves a padding node


@pytest.mark.parametrize("use_pallas", [False, True])
def test_binary_spmm_grad_matches_jax(graphs, use_pallas):
    jg, tg, n = graphs
    rs = np.random.RandomState(5)
    x = rs.randn(jg.n_node, 12).astype(np.float32)
    ct = rs.randn(jg.n_node, 12).astype(np.float32)
    ct[n:] = 0.0
    want, vjp = jax.vjp(lambda x_: jax_binary_spmm(jg, x_, use_pallas=use_pallas),
                        jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(ct))
    tx = _leaf(x)
    got = binary_spmm(tg, tx)
    got.backward(torch.from_numpy(ct))
    tol = 2e-3 if use_pallas else 1e-5
    np.testing.assert_allclose(got.detach().numpy()[:n], np.asarray(want)[:n], rtol=tol, atol=tol)
    np.testing.assert_allclose(tx.grad.numpy()[:n], np.asarray(jdx)[:n], rtol=tol, atol=tol)
    assert (tx.grad[n:] == 0).all()  # padding rows get no gradient


@pytest.mark.parametrize("which", ["dst", "src"])
def test_gather_grads_match_jax(graphs, which):
    """Against the JAX package's gathers, whose VJPs run the Pallas segment
    sums in interpret mode at ``precision="highest"`` (≈ exact f32)."""
    jg, tg, n = graphs
    rs = np.random.RandomState(6)
    x = rs.randn(jg.n_node, 8).astype(np.float32)
    ct = rs.randn(jg.n_edge, 8).astype(np.float32)
    jfn, tfn = {"dst": (jax_gather_by_dst, gather_by_dst),
                "src": (jax_gather_by_src, gather_by_src)}[which]
    want, vjp = jax.vjp(lambda x_: jfn(x_, jg), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(ct))
    tx = _leaf(x)
    got = tfn(tx, tg)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(tx.grad.numpy()[:n], np.asarray(jdx)[:n], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("route", ["fused", "half-fused-std", "half-fused-dropout"])
def test_padding_garbage_does_not_change_gradients(graphs, route):
    """Padding rows of ``x`` and ``h`` hold large finite garbage: every
    parameter gradient and the real rows of the input gradients stay as
    they are with zero padding rows."""
    _, tg, n = graphs
    rs = np.random.RandomState(7)
    x = rs.randn(tg.n_node, 24).astype(np.float32)
    x[n:] = 0.0
    x_bad = x.copy()
    x_bad[n:] = 1e3 * rs.randn(tg.n_node - n, 24)
    aggs, parity = {"fused": (("mean", "max"), True),
                    "half-fused-std": (("mean", "std"), False),
                    "half-fused-dropout": (("mean", "mean2"), True)}[route]
    rate = 0.5 if route == "half-fused-dropout" else 0.0

    def grads(inp, layer_input):
        model = NodeClassifier(24, 16, 5, aggs, dropout_rate=rate, parity=parity,
                               device="cpu", generator=torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(1) if rate else None
        ti = torch.tensor(inp, requires_grad=True)
        if layer_input:  # the MMA layer alone, fed h directly
            out = model.mma(ti[:, :16].contiguous(), tg, generator=gen)
        else:
            out = model(ti, tg, training=True, generator=gen)
        out[:n].sum().backward()
        return [p.grad.clone() for p in model.parameters() if p.grad is not None], ti.grad

    for layer_input in (False, True):
        want_p, want_x = grads(x, layer_input)
        got_p, got_x = grads(x_bad, layer_input)
        assert len(got_p) == len(want_p) > 0
        for g, w in zip(got_p, want_p):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6 * w.abs().max().item())
        torch.testing.assert_close(got_x[:n], want_x[:n], rtol=1e-6, atol=1e-6)


def test_mma_layer_backward_runs_through_the_functions(graphs):
    """The layer's gradient graph holds the port's Functions, not torch's
    own gather/index_add backward (which would be atomic on the card)."""
    _, tg, _ = graphs
    layer = MMALayer(16, 8, ("mean", "mean2"), device="cpu")
    h = torch.randn(tg.n_node, 16, requires_grad=True)
    out = layer(h, tg)
    names, stack, seen = set(), [out.grad_fn], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    assert {"_EdgeProgramLeanBackward", "_BinarySpmmBackward"} <= names, names
    assert not any(n.startswith(("IndexSelect", "IndexAdd")) for n in names), names
