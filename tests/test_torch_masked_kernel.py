"""The port's ``fused_masked_aggregate`` (kernel 12's plain version and its
autograd Function) against the JAX package's ``fused_masked_aggregate``
(Pallas ``_masked_kernel`` in interpret mode, ``precision="highest"``), on
the CPU.

Tolerance rtol 1e-5 / atol 1e-5: f32 sums of the same terms, taken in
another order on the JAX side (its one-hot contraction in three bf16
passes). The JAX kernel sums the padding edges into the padding rows; the
port skips them, so only real rows are compared. Against the port's own
lean route, within 1e-5 of each tensor's largest value.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mma_tpu.graph.build import graph_from_edges as jax_graph_from_edges
from mma_tpu.ops.pallas.fused_mma import fused_masked_aggregate as jax_fused_masked_aggregate

from mma_tpu_torch.graph import graph_from_edges
from mma_tpu_torch.ops import fused_masked_aggregate, get_agg_spec
from mma_tpu_torch.ops.cuda import fused_mma
from mma_tpu_torch.ops.gather import gather_by_dst, gather_by_src
from mma_tpu_torch.ops.masked_aggregate import (
    masked_multi_aggregate,
    mma_mask_projections,
    sigmoid_lane_pattern,
)


@pytest.fixture(scope="module")
def graphs():
    """300 nodes, the last 40 without in-edges; padding edges at the tail."""
    rs = np.random.RandomState(0)
    n = 300
    src = rs.randint(0, n, 2400).astype(np.int32)
    dst = rs.randint(0, n - 40, 2400).astype(np.int32)
    return jax_graph_from_edges(src, dst, n), graph_from_edges(src, dst, n, device="cpu"), n


def _pattern(kind, k, f):
    """(K·F,) bool lane pattern: an aggregator set's N1 table, or all σ."""
    if kind == "all_sigmoid":
        return np.ones(k * f, bool)
    specs = [get_agg_spec(a) for a in kind.split(",")]
    return sigmoid_lane_pattern(specs, "new_sigmoid", True, f, "cpu").numpy() > 0


@pytest.mark.parametrize("k,f,kind", [
    (2, 8, "mean,mean2"),       # σ on every lane
    (2, 8, "mean,max"),         # σ on the first block, the raw logits on the second
    (3, 12, "all_sigmoid"),
    (1, 5, "max"),              # identity only; F % 4 != 0 (the kernel's scalar path)
])
def test_fused_masked_aggregate_matches_jax(graphs, k, f, kind):
    """Forward and VJP (``dlogits``, ``dh_src``) against the JAX kernel and
    its custom VJP; rows without edges are 0, padding edges get zero
    gradient, and nothing launches on the CPU."""
    jg, tg, n = graphs
    pat = _pattern(kind, k, f)
    rs = np.random.RandomState(10 * k + f)
    logits = rs.randn(jg.n_edge, k * f).astype(np.float32)
    h_src = rs.randn(jg.n_edge, f).astype(np.float32)
    ct = rs.randn(jg.n_node, k * f).astype(np.float32)
    e_mask = np.asarray(jg.edge_mask)
    assert not e_mask.all()

    def jrun(l_, h_):
        return jax_fused_masked_aggregate(l_, h_, jnp.asarray(pat), jg, k, precision="highest")

    want, vjp = jax.vjp(jrun, jnp.asarray(logits), jnp.asarray(h_src))
    want_dl, want_dh = vjp(jnp.asarray(ct))

    tl = torch.from_numpy(logits).requires_grad_()
    th = torch.from_numpy(h_src).requires_grad_()
    before = dict(fused_mma.LAUNCHES)
    got = fused_masked_aggregate(tl, th, torch.from_numpy(pat), tg, k)
    (got * torch.from_numpy(ct)).sum().backward()
    assert fused_mma.LAUNCHES == before  # the plain versions on the CPU
    got = got.detach().numpy()
    assert got.shape == (tg.n_node, k * f)
    np.testing.assert_allclose(got[:n], np.asarray(want)[:n], rtol=1e-5, atol=1e-5)
    assert not got[260:].any()  # rows without edges, and the padding node
    for name, g, w in (("dlogits", tl.grad, want_dl), ("dh_src", th.grad, want_dh)):
        g = g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)
        assert not g[~e_mask].any(), name  # padding edges


@pytest.mark.parametrize("parity", [True, False])
def test_fused_masked_aggregate_matches_lean_route(graphs, parity):
    """On the half-fused route's logits ``c[dst] + d[src]`` and ``h[src]``,
    ``S`` and the gradients of ``h`` and ``mask_weights`` equal the lean
    route's in ``masked_multi_aggregate``: ``softmax``/``softmin`` pass
    ``S`` through, with the raw logits under parity and σ without."""
    _, tg, n = graphs
    specs = [get_agg_spec(a) for a in ("softmax", "softmin")]
    k, f = len(specs), 8
    rs = np.random.RandomState(5)
    h0 = torch.from_numpy(rs.randn(tg.n_node, f).astype(np.float32))
    mw0 = torch.from_numpy((rs.randn(k, 2 * f, f) / np.sqrt(f)).astype(np.float32))
    ct = torch.from_numpy(rs.randn(tg.n_node, k * f).astype(np.float32))
    pat = sigmoid_lane_pattern(specs, "new_sigmoid", parity, f, "cpu")

    def run(masked):
        h, mw = h0.clone().requires_grad_(), mw0.clone().requires_grad_()
        if masked:
            c, d = mma_mask_projections(h, mw)
            logits = gather_by_dst(c, tg) + gather_by_src(d, tg)
            s = fused_masked_aggregate(logits, gather_by_src(h, tg), pat, tg, k)
        else:
            s = masked_multi_aggregate(h, tg, mw, specs, parity=parity).reshape(-1, k * f)
        (s[:n] * ct[:n]).sum().backward()
        return s.detach()[:n], h.grad, mw.grad

    for name, got, want in zip(("S", "dh", "dmask_weights"), run(True), run(False)):
        # f32 sums of up to a few hundred edges in another order: within
        # 1e-5 of each tensor's largest value, as tests/test_torch_wide_program.py.
        scale = max(1.0, want.abs().max().item())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=name)


def test_masked_segment_sum_rejects_what_the_kernel_does_not_take(graphs):
    """Bad dtypes, shapes and widths raise on any device; tensors off the
    card (meta here) reach the kernel path and raise there, launching
    nothing."""
    _, tg, _ = graphs
    e = tg.n_edge
    logits, h_src, pat = torch.zeros(e, 16), torch.zeros(e, 8), torch.ones(16, dtype=torch.bool)
    with pytest.raises(ValueError, match="float32"):
        fused_masked_aggregate(logits.double(), h_src, pat, tg, 2)
    with pytest.raises(ValueError, match="graph.n_edge"):
        fused_masked_aggregate(logits[:-1], h_src, pat, tg, 2)
    with pytest.raises(ValueError, match="h_src"):
        fused_masked_aggregate(logits, h_src[:, :4], pat, tg, 2)
    with pytest.raises(ValueError, match="F <= 128"):
        fused_masked_aggregate(torch.zeros(e, 132), torch.zeros(e, 132),
                               torch.ones(132, dtype=torch.bool), tg, 1)
    with pytest.raises(ValueError, match="K·F <= 512"):
        fused_masked_aggregate(torch.zeros(e, 520), torch.zeros(e, 130),
                               torch.ones(520, dtype=torch.bool), tg, 4)
    before = dict(fused_mma.LAUNCHES)
    meta = [t.to("meta") for t in (logits, h_src, pat.float(), tg.real_row_ptr)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_mma.masked_segment_sum(*meta)
    with pytest.raises(ValueError, match="several devices"):
        fused_mma._masked_segment_sum_kernel(meta[0], h_src, pat.float(), tg.real_row_ptr)
    assert fused_mma.LAUNCHES == before
