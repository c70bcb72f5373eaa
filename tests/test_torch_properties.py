"""Property-based tests (hypothesis) of the port over random graphs: the
counterpart of ``test_properties.py``.

1. The port's plain path (the CPU) matches the per-node-loop oracle
   (``tests/oracle.py``, the reference's semantics) for a drawn aggregator
   and activation on a drawn graph.
2. The port's plain path matches the JAX package's XLA path, value and
   gradients, on drawn graphs, aggregator sets and backward modes.
3. On the card (skipped without CUDA): kernels 2-3 and 9-12 match their
   plain versions on drawn skewed graphs (a hub destination, a hub
   source, a run of empty rows).

The JAX property of edge-shard partition invariance has no counterpart
here: a world of gloo ranks for every example costs too much, and
``tests/test_torch_parallel.py`` holds the edge-sharded forward, gradients
and steps against the unsharded ones on fixed seeds.

Graphs come from ``graph_from_dense`` on adjacencies drawn with numpy
from the drawn seeds. This file imports JAX only inside property 2, so the
card's property also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_properties.py
"""

import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from mma_tpu_torch.graph import graph_from_dense  # noqa: E402
from mma_tpu_torch.ops import get_agg_spec, masked_multi_aggregate  # noqa: E402
from mma_tpu_torch.ops.cuda import fused_mma  # noqa: E402
from mma_tpu_torch.ops.masked_aggregate import sigmoid_lane_pattern  # noqa: E402

from oracle import oracle_mma_aggregator  # noqa: E402

USABLE = [
    "sum", "sum2", "sum3", "sum4",
    "mean", "mean2", "mean3", "mean4",
    "max", "max2", "max3", "max4",
    "min", "min2", "min3", "min4",
    "softmax", "softmin",
]

F = 16

# No deadline (JAX's first calls vary), no example database.
PROP = dict(deadline=None, database=None, print_blob=True)


def random_symmetric_adjacency(n, p, seed):
    """A random symmetric 0/1 adjacency without self-loops in which every
    node has a neighbour, drawn as ``tests/helpers.py`` draws it."""
    rs = np.random.RandomState(seed)
    a = (rs.rand(n, n) < p).astype(np.float32)
    a = np.triu(a, 1)
    a = a + a.T
    for i in range(n):
        if a[i].sum() == 0:
            j = (i + 1) % n
            a[i, j] = a[j, i] = 1.0
    return a


def _graph_and_features(n, p, seed, f=F):
    a = random_symmetric_adjacency(n, p, seed)
    graph = graph_from_dense(a, device="cpu")
    rs = np.random.RandomState(seed + 1000)
    h = np.zeros((graph.n_node, f), np.float32)
    h[:n] = rs.randn(n, f)
    return a, graph, h


@settings(max_examples=12, **PROP)
@given(
    n=st.integers(6, 40),
    pct=st.integers(5, 40),
    seed=st.integers(0, 2**31 - 1),
    agg=st.sampled_from(USABLE),
    activation=st.sampled_from(["new_sigmoid", "sigmoid"]),
)
def test_plain_path_matches_oracle(n, pct, seed, agg, activation):
    a, graph, h = _graph_and_features(n, pct / 100.0, seed)
    add_all = [np.nonzero(a[i])[0] for i in range(n)]
    rs = np.random.RandomState(seed % 1000)
    mask_w = (rs.randn(1, 2 * F, F) * 0.3).astype(np.float32)
    got = masked_multi_aggregate(torch.from_numpy(h), graph, torch.from_numpy(mask_w),
                                 (get_agg_spec(agg),), activation=activation, parity=True)
    want = oracle_mma_aggregator(agg, h[:n], add_all, mask_w[0], activation)
    np.testing.assert_allclose(got[:n, 0, :].numpy(), want, rtol=3e-5, atol=3e-5)


@settings(max_examples=6, **PROP)
@given(
    n=st.integers(6, 48),
    pct=st.integers(5, 30),
    seed=st.integers(0, 2**31 - 1),
    aggs=st.lists(st.sampled_from(USABLE), min_size=1, max_size=3, unique=True),
    # None: the lean route (kernels 2-3's plain versions); the named modes
    # take the wide route (kernels 9-11's) with that backward.
    bwd_mode=st.sampled_from([None, "csc_gather", "payload_permute"]),
)
def test_plain_path_matches_jax_fwd_and_grads(n, pct, seed, aggs, bwd_mode):
    import jax
    import jax.numpy as jnp

    from mma_tpu.graph.build import graph_from_dense as jax_graph_from_dense
    from mma_tpu.ops import get_agg_spec as jax_get_agg_spec
    from mma_tpu.ops import masked_multi_aggregate as jax_masked_multi_aggregate

    a, graph, h = _graph_and_features(n, pct / 100.0, seed)
    jgraph = jax_graph_from_dense(a)
    k = len(aggs)
    rs = np.random.RandomState(seed % 1000)
    mask_w = (rs.randn(k, 2 * F, F) * 0.3).astype(np.float32)
    ct = rs.randn(graph.n_node, k, F).astype(np.float32)

    jspecs = tuple(jax_get_agg_spec(s) for s in aggs)

    def jloss(h_, w_):
        out = jax_masked_multi_aggregate(h_, jgraph, w_, jspecs, parity=True, use_pallas=False)
        out = jnp.where(jgraph.node_mask[:, None, None], out, 0.0)
        return jnp.sum(out * ct), out

    (_, want), want_grads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(mask_w))

    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(mask_w).requires_grad_()
    out = masked_multi_aggregate(th, graph, tw, tuple(get_agg_spec(s) for s in aggs),
                                 parity=True, pallas_bwd_mode=bwd_mode)
    out = torch.where(graph.node_mask[:, None, None], out, 0.0)
    (out * torch.from_numpy(ct)).sum().backward()

    for got, w, name in ((out.detach(), want, "out"), (th.grad, want_grads[0], "dh"),
                         (tw.grad, want_grads[1], "dW")):
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-5 * scale, err_msg=name)


# ---- the card: kernels 2-3 and 9-12 against their plain versions ----------


def skewed_adjacency(n, pct, seed, hub_in, hub_out):
    """A random 0/1 adjacency (``adj[i, j]`` ⇒ ``j → i``) with node 0 the
    destination of ``hub_in`` edges, node 1 the source of ``hub_out`` edges
    and the rows of the middle fifth empty."""
    rs = np.random.RandomState(seed)
    adj = (rs.rand(n, n) < pct / 100.0).astype(np.float32)
    adj[0, rs.choice(n, min(hub_in, n), replace=False)] = 1.0
    adj[rs.choice(n, min(hub_out, n), replace=False), 1] = 1.0
    adj[2 * n // 5:3 * n // 5] = 0.0
    return adj


def _close(got, want, what):
    """f32 sums in another order: within 1e-5 of the largest magnitude."""
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item(),
                               msg=what)


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA GPU and nvcc")
@settings(max_examples=12, **PROP)
@given(
    n=st.integers(16, 400),
    pct=st.integers(1, 15),
    seed=st.integers(0, 2**31 - 1),
    hub_in=st.integers(0, 400),
    hub_out=st.integers(0, 400),
    fk=st.sampled_from([(8, 1), (12, 3), (16, 2), (64, 2), (96, 4), (128, 4)]),
)
def test_kernels_match_plain_on_skewed_graphs(n, pct, seed, hub_in, hub_out, fk):
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 parity of h @ W_bot
    cuda = torch.device("cuda")
    f, k = fk
    kf = k * f
    graph = graph_from_dense(skewed_adjacency(n, pct, seed, hub_in, hub_out), device=cuda)
    rs = np.random.RandomState(seed % 997)

    def draw(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).to(cuda)

    nn_ = graph.n_node
    h, c, d, ct = draw(nn_, f), draw(nn_, kf), draw(nn_, kf), draw(nn_, kf)
    w_bot = draw(f, kf, scale=f ** -0.5)
    aggs = [USABLE[i] for i in rs.choice(len(USABLE), k, replace=False)]
    pat = sigmoid_lane_pattern([get_agg_spec(a) for a in aggs], "new_sigmoid", True, f, cuda)
    rp, cp, src, dst_csc = graph.real_row_ptr, graph.real_col_ptr, graph.src, graph.dst_csc
    logits, h_src = draw(graph.n_edge, kf), draw(graph.n_edge, f)

    calls = {
        "edge_program_lean": (fused_mma.edge_program_lean,
                              fused_mma.edge_program_lean_reference,
                              (c, w_bot, h, pat, src, rp), (cp, dst_csc)),
        "edge_program_lean_bwd": (fused_mma.edge_program_lean_bwd,
                                  fused_mma.edge_program_lean_bwd_reference,
                                  (c, w_bot, h, pat, src, rp, cp, dst_csc, ct), ()),
        "edge_program_fwd": (fused_mma.edge_program_fwd, fused_mma.edge_program_fwd_reference,
                             (c, d, h, pat, src, rp), ()),
        "edge_program_bwd": (fused_mma.edge_program_bwd, fused_mma.edge_program_bwd_reference,
                             (c, d, h, pat, src, rp, ct), ()),
        "edge_program_bwd_csc": (fused_mma.edge_program_bwd_csc,
                                 fused_mma.edge_program_bwd_csc_reference,
                                 (c, d, h, pat, dst_csc, cp, ct), ()),
        "masked_segment_sum": (fused_mma.masked_segment_sum,
                               fused_mma.masked_segment_sum_reference,
                               (logits, h_src, pat, rp), ()),
    }
    for name, (kernel, plain, args, extra) in calls.items():
        before = fused_mma.LAUNCHES[name]
        got = kernel(*args, *extra)
        torch.cuda.synchronize()
        assert fused_mma.LAUNCHES[name] == before + 1, name
        want = plain(*args)
        got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{name}[{i}]")
        again = kernel(*args, *extra)
        again = again if isinstance(again, tuple) else (again,)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), name  # run to run
