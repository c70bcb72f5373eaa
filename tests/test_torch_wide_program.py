"""The port's wide MMA edge program (kernels 9-11 and their autograd
Function) and ``masked_multi_aggregate``'s ``pallas_bwd_mode`` route
against the JAX package, on the CPU (the kernels' plain versions).

The JAX side runs its Pallas kernels in interpret mode. Tolerances:

- ``edge_program`` against ``fused_mma_edge_program(precision="highest")``
  on the real nodes: 1e-5 forward and 2e-5 gradients, as the JAX package
  holds its own kernels against XLA
  (``tests/test_graph_and_native.py:189-242``);
- ``edge_program_fwd`` and ``edge_program_bwd`` (both payload modes) on a
  skewed graph against the same JAX function's output and gradients:
  relative 2e-5 with a floor of 2e-5 times the tensor's largest value
  (f32 sums of up to 320 terms, taken in another order);
- ``masked_multi_aggregate`` against the JAX package's Pallas route (its
  default ``precision="high"``, two bf16 passes) at the scale-aware
  tolerance of ``tests/test_graph_and_native.py:166-173``, and against the
  port's own lean route within 1e-5 of each tensor's largest value (f32
  sums in another order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mma_tpu.graph.build import graph_from_edges as jax_graph_from_edges
from mma_tpu.ops.aggregators import get_agg_spec as jax_get_agg_spec
from mma_tpu.ops.masked_aggregate import masked_multi_aggregate as jax_masked_multi_aggregate
from mma_tpu.ops.pallas.fused_mma import fused_mma_edge_program

from helpers import random_symmetric_graph

from mma_tpu_torch.graph import graph_from_edges
from mma_tpu_torch.ops import get_agg_spec
from mma_tpu_torch.ops.cuda import fused_mma
from mma_tpu_torch.ops.masked_aggregate import masked_multi_aggregate


def _graphs(n, p, seed):
    """The JAX package's graph and the port's over the same edges and padding."""
    _, _, jg = random_symmetric_graph(n, p=p, seed=seed)
    mask = np.asarray(jg.edge_mask)
    tg = graph_from_edges(np.asarray(jg.src)[mask], np.asarray(jg.dst)[mask], n,
                          n_node_pad=jg.n_node, n_edge_pad=jg.n_edge, device="cpu")
    return jg, tg


def _grads(fn, *inputs, ct):
    leaves = [torch.from_numpy(x).requires_grad_() for x in inputs]
    out = fn(*leaves)
    (out * torch.from_numpy(ct)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("bwd_mode", ["csc_gather", "payload_permute"])
@pytest.mark.parametrize("n_agg,n,p", [(1, 100, 0.1), (2, 150, 0.08), (3, 257, 0.05)])
def test_edge_program_matches_jax(n_agg, n, p, bwd_mode):
    """Forward, ``dc``, ``dd`` and ``dh`` against the JAX package's wide
    program with the same backward mode, with a sigmoid/identity mixed lane
    pattern; the padding node (target and source of every padding edge)
    gets no output and no gradient."""
    jg, tg = _graphs(n, p, seed=11 + n_agg)
    rs = np.random.RandomState(n_agg)
    f = 32
    c, d = (rs.randn(jg.n_node, n_agg * f).astype(np.float32) for _ in range(2))
    h = rs.randn(jg.n_node, f).astype(np.float32)
    pat = np.repeat(np.array([k > 0 for k in range(n_agg)]), f)
    ct = rs.randn(jg.n_node, n_agg * f).astype(np.float32)
    nm = np.asarray(jg.node_mask)
    ct_real = np.where(nm[:, None], ct, 0.0).astype(np.float32)

    def jfused(c_, d_, h_):
        out = fused_mma_edge_program(c_, d_, h_, jnp.asarray(pat), jg, n_agg,
                                     precision="highest", bwd_mode=bwd_mode)
        return jnp.sum(out * ct_real), out

    (_, want), jgrads = jax.value_and_grad(jfused, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(c), jnp.asarray(d), jnp.asarray(h))
    tpat = torch.from_numpy(pat.astype(np.float32))
    before = dict(fused_mma.LAUNCHES)
    got, grads = _grads(
        lambda c_, d_, h_: fused_mma.edge_program(
            c_, d_, h_, tpat, tg.src, tg.real_row_ptr, tg.real_col_ptr, tg.src_perm,
            tg.dst_csc, bwd_mode),
        c, d, h, ct=ct_real)
    assert fused_mma.LAUNCHES == before  # plain versions on the CPU
    np.testing.assert_allclose(got[nm], np.asarray(want)[nm], rtol=1e-5, atol=1e-5)
    for name, g, w in zip(("dc", "dd", "dh"), grads, jgrads):
        np.testing.assert_allclose(g[nm], np.asarray(w)[nm], rtol=2e-5, atol=2e-5,
                                   err_msg=name)
        assert not g[~nm].any(), name
    assert not got[~nm].any()


@pytest.fixture(scope="module")
def skewed_graphs():
    """The shape the card's chunk pass is built for, small: 400 nodes, node
    5 the destination of a 320-edge row, rows 100-159 and the last 30 rows
    empty, and 70 padding edges past the real ones (the JAX package's
    graph and the port's over the same edges and padding)."""
    rs = np.random.RandomState(21)
    n = 400
    live = np.setdiff1d(np.arange(n - 30), np.r_[5, 100:160])
    dst = np.concatenate([np.full(320, 5), rs.choice(live, 2000)]).astype(np.int32)
    src = rs.randint(0, n, dst.shape[0]).astype(np.int32)
    n_edge = dst.shape[0] + 70
    jg = jax_graph_from_edges(src, dst, n, n_edge_pad=n_edge)
    tg = graph_from_edges(src, dst, n, n_node_pad=jg.n_node, n_edge_pad=n_edge, device="cpu")
    return jg, tg


@pytest.mark.parametrize("emit_payload", [True, False])
@pytest.mark.parametrize("f,n_agg", [(16, 2), (64, 2), (12, 3)])
def test_wide_kernels_match_jax_on_a_skewed_graph(skewed_graphs, f, n_agg, emit_payload):
    """Kernels 9 and 10 through their plain versions, the functions the
    card's kernels are held against, against the JAX package's
    ``fused_mma_edge_program`` (``precision="highest"``) on a graph with a
    320-edge row, runs of empty rows and padding edges: ``S`` against its
    output; ``dc`` against its ``c`` gradient; the payload summed by source
    against its ``d`` and ``h`` gradients, and 0 on the padding edges. This
    closes the chain card → plain version → JAX for the skewed shape."""
    jg, tg = skewed_graphs
    rs = np.random.RandomState(f + n_agg)
    kf = n_agg * f
    nm = np.asarray(jg.node_mask)
    c, d, ct = (np.where(nm[:, None], rs.randn(jg.n_node, kf), 0.0).astype(np.float32)
                for _ in range(3))
    h = np.where(nm[:, None], rs.randn(jg.n_node, f), 0.0).astype(np.float32)
    pat = (np.arange(kf) // f % 2 == 0) ^ (rs.rand(kf) > 0.8)  # mixed lanes within a block

    def jfused(c_, d_, h_):
        out = fused_mma_edge_program(c_, d_, h_, jnp.asarray(pat), jg, n_agg,
                                     precision="highest", bwd_mode="payload_permute")
        return jnp.sum(out * ct), out

    (_, want), (want_dc, want_dd, want_dh) = jax.value_and_grad(
        jfused, argnums=(0, 1, 2), has_aux=True)(jnp.asarray(c), jnp.asarray(d), jnp.asarray(h))
    t = {k: torch.from_numpy(v) for k, v in dict(c=c, d=d, h=h, ct=ct).items()}
    tpat = torch.from_numpy(pat.astype(np.float32))
    rp = tg.real_row_ptr
    assert int((rp[1:] - rp[:-1]).max()) == 320 and int(rp[-1]) == tg.n_edge - 70
    fwd = (t["c"], t["d"], t["h"], tpat, tg.src, rp)
    before = dict(fused_mma.LAUNCHES)
    got = fused_mma.edge_program_fwd(*fwd)
    dc, payload = fused_mma.edge_program_bwd(*fwd, t["ct"], emit_payload=emit_payload)
    assert fused_mma.LAUNCHES == before  # plain versions on the CPU

    def close(got_, want_, what):
        want_ = np.asarray(want_)[nm]
        np.testing.assert_allclose(got_.numpy()[nm], want_, rtol=2e-5,
                                   atol=2e-5 * np.abs(want_).max(), err_msg=what)

    close(got, want, "S")
    close(dc, want_dc, "dc")
    if not emit_payload:
        assert payload is None
        return
    assert payload.shape == (tg.n_edge, kf + f)
    assert not payload[int(rp[-1]):].any()  # padding edges
    by_src = fused_mma.segment_sum_csr(payload, tg.real_col_ptr, index=tg.src_perm)
    close(by_src[:, :kf], want_dd, "dd")
    close(by_src[:, kf:], want_dh, "dh")


@pytest.mark.parametrize("n_agg", [1, 3])
def test_edge_program_backward_halves_agree(n_agg):
    """The two src-keyed halves give the same ``[dd ‖ dh]``: the payload of
    kernel 10 summed by source and kernel 11's CSC recompute. Padding edges
    get payload 0, and kernel 10 without the payload gives the same ``dc``."""
    _, tg = _graphs(120, 0.08, seed=5)
    rs = np.random.RandomState(7)
    f = 16
    n = tg.n_node
    c, d, ct = (torch.from_numpy(rs.randn(n, n_agg * f).astype(np.float32)) for _ in range(3))
    h = torch.from_numpy(rs.randn(n, f).astype(np.float32))
    pat = torch.from_numpy(np.repeat(np.arange(n_agg) % 2 == 0, f).astype(np.float32))
    rp, cp = tg.real_row_ptr, tg.real_col_ptr
    dc, payload = fused_mma.edge_program_bwd(c, d, h, pat, tg.src, rp, ct)
    dc_only, none = fused_mma.edge_program_bwd(c, d, h, pat, tg.src, rp, ct, emit_payload=False)
    assert none is None
    np.testing.assert_array_equal(dc_only.numpy(), dc.numpy())
    assert payload.shape == (tg.n_edge, n_agg * f + f)
    assert not payload[int(rp[-1]):].any()
    by_src = fused_mma.segment_sum_csr(payload, cp, index=tg.src_perm)
    csc = fused_mma.edge_program_bwd_csc(c, d, h, pat, tg.dst_csc, cp, ct)
    np.testing.assert_allclose(csc.numpy(), by_src.numpy(), rtol=1e-5,
                               atol=1e-5 * np.abs(by_src.numpy()).max())


@pytest.mark.parametrize("bwd_mode", ["payload_permute", "csc_gather"])
def test_masked_multi_aggregate_wide_route_matches_jax_and_lean(bwd_mode):
    """``pallas_bwd_mode`` takes the wide program: forward and the gradients
    of ``h`` and ``mask_weights`` against the JAX package's
    ``use_pallas=True, pallas_bwd_mode=…`` and the port's lean route."""
    jg, tg = _graphs(150, 0.08, seed=3)
    aggs = ("mean", "max")  # sigmoid and raw-logit lanes
    rs = np.random.RandomState(4)
    f, k = 16, len(aggs)
    h = rs.randn(jg.n_node, f).astype(np.float32)
    h[150:] = 0.0
    mw = (rs.randn(k, 2 * f, f) / np.sqrt(f)).astype(np.float32)
    nm = np.asarray(jg.node_mask)
    ct = np.where(nm[:, None, None], rs.randn(jg.n_node, k, f), 0.0).astype(np.float32)
    jspecs = [jax_get_agg_spec(a) for a in aggs]
    specs = [get_agg_spec(a) for a in aggs]

    def jloss(h_, mw_):
        out = jax_masked_multi_aggregate(h_, jg, mw_, jspecs, use_pallas=True,
                                         pallas_bwd_mode=bwd_mode)
        return jnp.sum(out * ct), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(mw))
    wide, wide_g = _grads(
        lambda h_, mw_: masked_multi_aggregate(h_, tg, mw_, specs, pallas_bwd_mode=bwd_mode),
        h, mw, ct=ct)
    lean, lean_g = _grads(lambda h_, mw_: masked_multi_aggregate(h_, tg, mw_, specs), h, mw,
                          ct=ct)

    def close(got, ref, what, rtol, atol_rel):
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_rel * scale, err_msg=what)

    close(wide[nm], np.asarray(want)[nm], "forward vs JAX", 2e-3, 2e-3)
    close(wide[nm], lean[nm], "forward vs lean", 1e-5, 1e-5)
    for name, g, jw, lw in zip(("dh", "dmask_weights"), wide_g, jgrads, lean_g):
        close(g, np.asarray(jw), f"{name} vs JAX", 5e-2, 5e-5)
        close(g, lw, f"{name} vs lean", 1e-5, 1e-5)


def test_unknown_pallas_bwd_mode_raises():
    _, tg = _graphs(20, 0.2, seed=0)
    h = torch.zeros(tg.n_node, 8)
    mw = torch.zeros(1, 16, 8)
    with pytest.raises(ValueError, match="pallas_bwd_mode"):
        masked_multi_aggregate(h, tg, mw, [get_agg_spec("mean")], pallas_bwd_mode="permute")
    with pytest.raises(ValueError, match="bwd_mode"):
        fused_mma.edge_program(torch.zeros(tg.n_node, 8), torch.zeros(tg.n_node, 8), h,
                               torch.zeros(8), tg.src, tg.real_row_ptr, tg.real_col_ptr,
                               tg.src_perm, tg.dst_csc, "gather")


def test_wide_kernels_raise_off_the_card_and_count_nothing():
    before = dict(fused_mma.LAUNCHES)
    n, f, kf = 4, 4, 8
    c, d = torch.zeros(n, kf, device="meta"), torch.zeros(n, kf, device="meta")
    h, pat = torch.zeros(n, f, device="meta"), torch.zeros(kf, device="meta")
    idx = torch.zeros(6, dtype=torch.int32, device="meta")
    ptr = torch.zeros(n + 1, dtype=torch.int32, device="meta")
    for call in (lambda: fused_mma.edge_program_fwd(c, d, h, pat, idx, ptr),
                 lambda: fused_mma.edge_program_bwd(c, d, h, pat, idx, ptr, c),
                 lambda: fused_mma.edge_program_bwd_csc(c, d, h, pat, idx, ptr, c),
                 lambda: fused_mma.segment_sum_sq_csr(torch.zeros(6, 3, device="meta"), ptr)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    assert fused_mma.LAUNCHES == before
