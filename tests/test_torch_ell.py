"""The port's ELL slice against the JAX package, on the CPU: the ``ops/ell``
primitives, the degree budgets and the degree-exact collate, the conv's ELL
route (degree-exact and single-width layouts) and its CSR routes on
degree-exact graphs, ``ZincNet`` on degree-ordered batches, Adam steps of
the degree-exact training step, ``remat`` and the synthetic edges of the
degree-exact layout.

Inputs come from numpy seeds (the 7-molecule generator of
``tests/test_ell.py``; ``in = out = 12``, ``edge_dim = 6``, ``towers = 2``).
The JAX side runs as ``tests/test_ell.py`` runs it: ``use_pallas=True``,
whose one Pallas kernel on these paths (``ell_gather_nodes_by_src``'s
CSC sum) runs in interpret mode. Tolerances are stated in each test.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mma_tpu.data.batching import batch_graphs as jax_batch_graphs
from mma_tpu.data.batching import degree_budgets as jax_degree_budgets
from mma_tpu.data import load_zinc as jax_load_zinc
from mma_tpu.graph.build import graph_from_edges as jax_graph_from_edges
from mma_tpu.models import ZincNet as JaxZincNet
from mma_tpu.nn.mma_conv import MultiMaskConv as JaxMultiMaskConv
from mma_tpu.ops import ell as jell
from mma_tpu.ops.pallas.segment_minmax import _dropout_keep as jax_dropout_keep
from mma_tpu.train.optim import make_optimizer as jax_make_optimizer

from test_torch_zinc_net import _assert_trees_close, _grad_tree, _np, _pop_bn_fed_biases

from mma_tpu_torch.convert import (
    multi_mask_conv_from_jax,
    multi_mask_conv_to_numpy,
    zinc_net_from_jax,
    zinc_net_to_numpy,
)
from mma_tpu_torch.data import batch_graphs, load_zinc
from mma_tpu_torch.data.batching import degree_budgets
from mma_tpu_torch.graph import graph_from_edges
from mma_tpu_torch.models import ZincNet
from mma_tpu_torch.models.zinc_net import _PoolByGraph
from mma_tpu_torch.nn.mma_conv import MultiMaskConv
from mma_tpu_torch.ops import ell
from mma_tpu_torch.ops.cuda import segment_minmax as mm
from mma_tpu_torch.ops.cuda.segment_minmax import dropout_keep
from mma_tpu_torch.ops.gather import gather_by_src
from mma_tpu_torch.ops.segment import segment_sum
from mma_tpu_torch.train import ZincConfig, make_optimizer
from mma_tpu_torch.train.loops import l1_loss, zinc_layout

C_IN, EDGE_DIM, TOWERS = 12, 6, 2
AVG_DEG = {"lin": 2.0, "log": 1.0, "exp": 5.0}
SCALERS = ("identity", "amplification")
AGG_SETS = [("min", "max"), ("sum", "mean", "var", "std")]
SMALL_NET = dict(num_layers=2, hidden=10, edge_hidden=6, towers=2, mlp_sizes=(10, 6, 1))
_GRAPH_FIELDS = ("src", "dst", "edge_mask", "node_mask", "deg", "row_ptr", "src_perm",
                 "col_ptr", "src_csc", "dst_csc")


def _mols(n_graphs=7, seed=0):
    """``tests/test_ell.py``'s molecule generator: trees of in-degree ≤ 4."""
    rs = np.random.RandomState(seed)
    num_nodes, srcs, dsts, nfeats, efeats, ys = [], [], [], [], [], []
    for _ in range(n_graphs):
        n = int(rs.randint(5, 14))
        s_, d_ = [], []
        deg = np.zeros(n, np.int64)
        for i in range(1, n):
            j = int(rs.randint(i))
            if deg[i] < 4 and deg[j] < 4:
                s_ += [i, j]
                d_ += [j, i]
                deg[i] += 1
                deg[j] += 1
        num_nodes.append(n)
        srcs.append(np.array(s_, np.int32))
        dsts.append(np.array(d_, np.int32))
        nfeats.append(rs.randint(0, 5, size=n).astype(np.int32))
        efeats.append(rs.randint(0, 3, size=len(s_)).astype(np.int32))
        ys.append(np.array([rs.randn()], np.float32))
    return num_nodes, srcs, dsts, nfeats, efeats, ys


def _batches(seed, exact=True):
    """The same molecules collated by both packages: ``(jax, port)``."""
    nn, ss, dd, nf, ef, ys = _mols(seed=seed)
    kw = dict(n_graph=len(nn) + 1, n_node=128, n_edge=256, node_feats=nf, edge_feats=ef,
              targets=ys)
    if exact:
        kw["ell_degree_budgets"] = jax_degree_budgets(nn, ss, dd, batch_size=len(nn))
    return jax_batch_graphs(nn, ss, dd, **kw), batch_graphs(nn, ss, dd, device="cpu", **kw)


def _equal(a, b, what):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=what)


def _close(got, want, rel, what):
    """``|got - want| <= rel · max|want|``: f32 sums in another order."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=what)


# ------------------------------------------------------------ primitives

@pytest.fixture(scope="module")
def bounded():
    """``tests/test_ell.py``'s bounded graph (64 nodes, in-degree ≤ 5) in
    both packages, with the specs the tests take: one width, and two
    buckets of different widths."""
    rs = np.random.RandomState(0)
    srcs, dsts = [], []
    for i in range(64):
        k = rs.randint(0, 6)
        srcs += list(rs.choice(64, size=k, replace=False))
        dsts += [i] * k
    src, dst = np.array(srcs, np.int32), np.array(dsts, np.int32)
    jg = jax_graph_from_edges(src, dst, 64)
    tg = graph_from_edges(src, dst, 64, n_node_pad=jg.n_node, n_edge_pad=jg.n_edge,
                          device="cpu")
    w = jell.max_indegree(jg)
    assert ell.max_indegree(tg) == w == 5
    specs = [ell.single_width_spec(tg.n_node, w), ell.EllSpec(bounds=(32, tg.n_node),
                                                              widths=(w, w + 1))]
    return jg, tg, specs


def _jspec(spec):
    return jell.EllSpec(bounds=spec.bounds, widths=spec.widths)


@pytest.mark.parametrize("si", [0, 1])
@pytest.mark.parametrize("prim", ["layout", "expand", "collapse", "gather_nodes_by_src",
                                  "slot_sum", "minmax_tied"])
def test_ell_primitives_match_jax(bounded, prim, si):
    """Each primitive's forward and VJP against the JAX package's. Gathers,
    masks, integer maps and min/max are exact (bit-equal); the slot sums
    add in the JAX order (bit-equal). ``ell_gather_nodes_by_src``'s VJP is
    kernel 1's plain version: within 1e-6 of the largest value of a float64
    sum, and within 3e-5 of the JAX Pallas CSC sum, whose one-hot product
    runs at ``precision="high"`` (three bf16 passes,
    ``mma_tpu/ops/pallas/fused_mma.py:1308``)."""
    jg, tg, specs = bounded
    spec = specs[si]
    js = _jspec(spec)
    rs = np.random.RandomState(10 + si)
    c = 8
    if prim == "layout":
        ell.validate_spec(tg, spec)
        for (ji, jv), (ti, tv) in zip(jell._bucket_ids(jg, js), ell._bucket_ids(tg, spec)):
            np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
            _equal(jv, tv, "valid")
        for a, b in zip(jell._slot_of_edge(jg, js), ell._slot_of_edge(tg, spec)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        narrow = ell.EllSpec(bounds=spec.bounds, widths=tuple(w - 1 for w in spec.widths))
        with pytest.raises(ValueError, match="width"):
            ell.validate_spec(tg, narrow)
        with pytest.raises(ValueError, match="no ELL slots"):
            ell.validate_spec(tg, ell.single_width_spec(32, 5))
        return
    if prim in ("expand", "collapse"):
        data = rs.randn(tg.n_edge, c).astype(np.float32)
        want, vjp = jax.vjp(lambda d: jell.ell_expand(d, jg, js), jnp.asarray(data))
        td = torch.tensor(data, requires_grad=True)
        got = ell.ell_expand(td, tg, spec)
        cts = [rs.randn(*o.shape).astype(np.float32) for o in want]
        for a, b in zip(want, got):
            _equal(a, b.detach(), "expand")
        if prim == "expand":
            (jd,) = vjp(tuple(jnp.asarray(ct) for ct in cts))
            torch.autograd.backward(got, [torch.from_numpy(ct) for ct in cts])
            _equal(jd, td.grad, "expand VJP")
        else:
            _equal(jell.ell_collapse([jnp.asarray(ct) for ct in cts], jg, js, c),
                   ell.ell_collapse([torch.from_numpy(ct) for ct in cts], tg, spec, c),
                   "collapse")
        return
    if prim == "gather_nodes_by_src":
        x = rs.randn(tg.n_node, c).astype(np.float32)
        want, vjp = jax.vjp(lambda v: jell.ell_gather_nodes_by_src(v, jg, js), jnp.asarray(x))
        tx = torch.tensor(x, requires_grad=True)
        got = ell.ell_gather_nodes_by_src(tx, tg, spec)
        for a, b in zip(want, got):
            _equal(a, b.detach(), "gather_nodes_by_src")
        # Cotangents on the valid slots only (the primitive's contract).
        cts = [rs.randn(*o.shape).astype(np.float32)
               * np.repeat(np.asarray(v), c, axis=1) for o, v in zip(want, jell.ell_valid(jg, js))]
        (jx,) = vjp(tuple(jnp.asarray(ct) for ct in cts))
        torch.autograd.backward(got, [torch.from_numpy(ct) for ct in cts])
        exact = np.zeros((tg.n_node, c))
        src = tg.src.numpy()
        for (ids, _), ct in zip(ell._bucket_ids(tg, spec), cts):
            np.add.at(exact, src[ids.numpy().reshape(-1)], ct.reshape(-1, c).astype(np.float64))
        _close(tx.grad.numpy(), exact, 1e-6, "gather_nodes_by_src VJP vs float64")
        _close(tx.grad.numpy(), jx, 3e-5, "gather_nodes_by_src VJP vs JAX")
        return
    w = spec.widths[0]
    valid_j = jell.ell_valid(jg, js)[0]
    valid_t = ell.ell_valid(tg, spec)[0]
    rows = spec.rows[0]
    if prim == "slot_sum":
        x2 = rs.randn(rows, w * c).astype(np.float32)
        ct = rs.randn(rows, c).astype(np.float32)
        for vj, vt in ((valid_j, valid_t), (None, None)):
            want, vjp = jax.vjp(lambda v: jell.masked_slot_sum(v, vj, w), jnp.asarray(x2))
            tx = torch.tensor(x2, requires_grad=True)
            got = ell.masked_slot_sum(tx, vt, w)
            _equal(want, got.detach(), "masked_slot_sum")
            got.backward(torch.from_numpy(ct))
            _equal(vjp(jnp.asarray(ct))[0], tx.grad, "masked_slot_sum VJP")
        return
    # Integer values: ties are common, so the first-hit order is exercised.
    x2 = rs.randint(-2, 3, size=(rows, w * c)).astype(np.float32)
    for ops in (("min", "max"), ("max",)):
        cts = [rs.randn(rows, c).astype(np.float32) for _ in ops]
        for vj, vt in ((valid_j, valid_t), (None, None)):
            want, vjp = jax.vjp(lambda v: jell.masked_minmax_firsthit(v, vj, ops, w),
                                jnp.asarray(x2))
            tx = torch.tensor(x2, requires_grad=True)
            got = ell.masked_minmax_firsthit(tx, vt, ops, w)
            for a, b in zip(want, got):
                _equal(a, b.detach(), f"masked_minmax_firsthit {ops}")
            torch.autograd.backward(got, [torch.from_numpy(ct) for ct in cts])
            (jx,) = vjp(tuple(jnp.asarray(ct) for ct in cts))
            _equal(jx, tx.grad, f"masked_minmax_firsthit {ops} VJP")


def test_pad_rows_slices_and_exact_expand():
    x = torch.arange(24.0).reshape(4, 6)
    assert ell.pad_rows(x, 6).shape == (6, 6) and not ell.pad_rows(x, 6)[4:].any()
    assert [t.tolist() for t in ell.slot_slices(x[:1], 3)] == [[[0.0, 1.0]], [[2.0, 3.0]],
                                                               [[4.0, 5.0]]]
    spec = ell.EllSpec(bounds=(2, 3), widths=(1, 2))
    parts = ell.ell_expand_exact(x, spec)
    assert [tuple(p.shape) for p in parts] == [(2, 6), (1, 12)]
    want = jell.ell_expand_exact(jnp.asarray(x.numpy()), jell.EllSpec((2, 3), (1, 2)))
    for a, b in zip(want, parts):
        _equal(a, b, "ell_expand_exact")


# ------------------------------------------------- budgets and the collate

@pytest.mark.parametrize("kw", [dict(), dict(worst_case=True), dict(include_zero=True),
                                dict(worst_case=True, include_zero=True, round_to=4),
                                dict(margin=0.25)])
def test_degree_budgets_match_jax(kw):
    """Observed and worst-case budgets, equal, on ZINC and the molecules."""
    ds = load_zinc("val", subset_size=300)
    for nn, ss, dd, bs in (([int(n) for n in ds.num_nodes], ds.edge_src, ds.edge_dst, 64),
                           _mols(seed=2)[:3] + (3,)):
        assert degree_budgets(nn, ss, dd, bs, **kw) == jax_degree_budgets(nn, ss, dd, bs, **kw)


@pytest.mark.parametrize("shuffle", [False, True])
def test_degree_exact_collate_matches_jax(shuffle):
    """``ZincDataset.batches(ell_degree_budgets=...)`` field for field and
    bit-equal, ``ell_hint``, ``ell_exact`` and ``csc_ell_exact`` included;
    the port's ``node_order``/``graph_ptr`` pool equals the by-graph sum."""
    jd, td = jax_load_zinc("val", subset_size=40), load_zinc("val", subset_size=40)
    cfg = ZincConfig(batch_size=16, batch_layout="degree_exact")
    n_node, n_edge, budgets = zinc_layout(cfg, [td])
    kw = dict(n_node=n_node, n_edge=n_edge, shuffle=shuffle, seed=3, ell_degree_budgets=budgets)
    pairs = list(zip(jd.batches(16, **kw), td.batches(16, device="cpu", **kw)))
    assert len(pairs) == 3
    for jb, tb in pairs:
        for f in _GRAPH_FIELDS:
            _equal(getattr(jb.graph, f), getattr(tb.graph, f), f"graph.{f}")
        for f in ("node_to_graph", "graph_mask", "node_feat", "edge_feat", "target"):
            _equal(getattr(jb, f), getattr(tb, f), f)
        for f in ("ell_hint", "ell_exact", "csc_ell_exact", "chunk_hint"):
            assert getattr(jb.graph, f) == getattr(tb.graph, f), f
        assert tb.graph.ell_exact and tb.graph.csc_ell_exact and not tb.nodes_grouped
        x = torch.randn(n_node, 5, generator=torch.Generator().manual_seed(0))
        pooled = _PoolByGraph.apply(x, tb.graph_ptr, tb.node_order, tb.node_to_graph)
        torch.testing.assert_close(pooled, segment_sum(x, tb.node_to_graph, tb.n_graph))


def test_degree_exact_collate_checks_its_budgets():
    nn, ss, dd = _mols(seed=1)[:3]
    budgets = degree_budgets(nn, ss, dd, len(nn))
    kw = dict(n_graph=8, n_node=128, n_edge=256, device="cpu")
    with pytest.raises(ValueError, match="budget"):
        batch_graphs(nn, ss, dd, ell_degree_budgets=(1,) + budgets[1:], **kw)
    with pytest.raises(ValueError, match="in-degree"):
        batch_graphs(nn, ss, dd, ell_degree_budgets=budgets[:2], **kw)
    with pytest.raises(ValueError, match="slot total"):
        batch_graphs(nn, ss, dd, ell_degree_budgets=budgets, **dict(kw, n_edge=64))


# ------------------------------------------------------------------ conv

def _conv_pair(aggs, parity, edge_format="auto"):
    kw = dict(in_channels=C_IN, out_channels=C_IN, aggregators=aggs, scalers=SCALERS,
              avg_deg=tuple(AVG_DEG.items()), edge_dim=EDGE_DIM, towers=TOWERS, parity=parity,
              max_degree_hint=4)
    jconv = JaxMultiMaskConv(edge_format=edge_format, **kw)
    params = jconv.init(jax.random.PRNGKey(0))
    conv = MultiMaskConv(C_IN, C_IN, aggs, SCALERS, AVG_DEG, edge_dim=EDGE_DIM, towers=TOWERS,
                         parity=parity, edge_format=edge_format, max_degree_hint=4,
                         device="cpu")
    multi_mask_conv_from_jax(_np(params), conv)
    return jconv, params, conv


def _jax_seeds(rng, n):
    """The ELL route's hash seeds from ``rng``: ``randint(key, (), 0,
    2³¹ - 1)`` of ``rng`` under parity, of each of ``split(rng, K)``
    otherwise (``mma_tpu/nn/mma_conv.py:334``, ``:439``)."""
    keys = [rng] if n == 1 else list(jax.random.split(rng, n))
    return [int(jax.random.randint(k, (), 0, 2**31 - 1, dtype=jnp.int32)) for k in keys]


def _port_conv(conv, tg, x, e, ct, seeds=None):
    """The port's output, ``dx`` and parameter gradients (JAX tree) of
    ``Σ where(node_mask, out, 0) · ct``."""
    conv.zero_grad(set_to_none=True)
    tx = torch.tensor(x, requires_grad=True)
    out = conv(tx, tg, torch.from_numpy(e), seed=seeds)
    (torch.where(tg.node_mask[:, None], out, 0.0) * torch.from_numpy(ct)).sum().backward()
    return out.detach().numpy(), tx.grad.numpy(), _grad_tree(conv, multi_mask_conv_to_numpy)


def _jax_conv(jconv, params, jg, x, e, ct, use_pallas, rng=None):
    def jloss(p, x_):
        out = jconv.apply(p, x_, jg, edge_attr=jnp.asarray(e), use_pallas=use_pallas, rng=rng)
        return jnp.sum(jnp.where(jg.node_mask[:, None], out, 0.0) * ct), out

    (_, want), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    return np.asarray(want), np.asarray(jgx), _np(jgp)


@pytest.mark.parametrize("route", ["ell-exact", "ell-single", "csr-exact"])
@pytest.mark.parametrize("aggs", AGG_SETS, ids=["minmax", "pna"])
@pytest.mark.parametrize("parity", [True, False])
def test_conv_matches_jax(route, aggs, parity):
    """Forward and every gradient of the conv on each layout against the JAX
    package: ``ell-exact`` the ELL route on a degree-exact batch,
    ``ell-single`` ``edge_format="ell"`` with ``max_degree_hint=4`` on the
    plain collate (the JAX side on its own plain collate of the same
    molecules), ``csr-exact`` ``edge_format="csr"`` on the degree-exact
    batch (min/max: kernels 6-7's plain versions; the PNA set: kernels
    1, 4, 5 and 8's) against the JAX XLA path there, as
    ``tests/test_ell.py:394-430``. The ELL routes run with dropout off and
    on (the JAX package's seeds); ``csr-exact`` off (its draws are the
    packages' own). Real rows and parameters: outputs within 1e-5 and
    gradients within 2e-5 of each tensor's largest value (f32 products and
    sums in another order; std's derivative amplifies the rounding of
    ``E[x²] − E[x]²``): with std in the set each gradient also gets four
    times the port's own change when ``x`` or the edge features move by one
    ulp, the allowance of ``tests/test_torch_zinc_net.py``. var and std are shift-invariant, so
    the gradient of the pre-NN bias before them is 0 in exact arithmetic
    and rounding noise on both sides: it is held within 2e-5 of its
    weight's gradient."""
    jb, tb = _batches(seed=3, exact=route != "ell-single")
    jg, tg = jb.graph, tb.graph
    jconv, params, conv = _conv_pair(aggs, parity, "ell" if route == "ell-single" else
                                     "csr" if route == "csr-exact" else "auto")
    rs = np.random.RandomState(1)
    x = rs.randn(tg.n_node, C_IN).astype(np.float32)
    e = rs.randn(tg.n_edge, EDGE_DIM).astype(np.float32)
    ct = rs.randn(tg.n_node, C_IN).astype(np.float32)
    m = tg.node_mask.numpy()
    rng = jax.random.PRNGKey(7)
    cases = [(None, None)]
    if route != "csr-exact":
        cases.append((rng, _jax_seeds(rng, 1 if parity else len(aggs))))
    before = dict(mm.LAUNCHES)
    outs = []
    for r, seeds in cases:
        out, gx, gp = _port_conv(conv, tg, x, e, ct, seeds)
        want, jgx, jgp = _jax_conv(jconv, params, jg, x, e, ct, route != "csr-exact", r)
        slack = jax.tree.map(lambda a: 0.0, jgp)
        slack_x = 0.0
        if "std" in aggs:
            up = np.float32(np.inf)
            for xn, en in ((np.where(m[:, None], np.nextafter(x, up), x), e),
                           (x, np.nextafter(e, up))):
                _, gx1, gp1 = _port_conv(conv, tg, xn, en, ct, seeds)
                slack = jax.tree.map(lambda s_, a, b: max(s_, 4 * np.abs(a - b).max()),
                                     slack, gp, gp1)
                slack_x = max(slack_x, 4 * np.abs(gx - gx1)[m].max())
        if not parity:
            for ki, a in enumerate(aggs):
                for tower, ws in zip(slack["pre_nns"][ki], jgp["pre_nns"][ki]):
                    if a in ("var", "std"):
                        tower[0]["b"] += 2e-5 * np.abs(ws[0]["w"]).max()
        what = f"{route} dropout={'on' if r is not None else 'off'}"
        _close(out[m], want[m], 1e-5, f"{what} out")
        np.testing.assert_allclose(gx[m], jgx[m], rtol=0,
                                   atol=2e-5 * np.abs(jgx[m]).max() + slack_x, err_msg=what)
        _assert_trees_close(gp, jgp, f"{what} grad", rel=2e-5, slack=slack)
        outs.append(out[m])
    assert mm.LAUNCHES == before
    if len(outs) == 2:
        assert not np.allclose(*outs)  # dropout on moved the output: masks applied


@pytest.mark.parametrize("parity", [True, False])
def test_ell_dropout_masks_are_bit_equal(parity):
    """The masks the ELL route applies: the port's ``dropout_keep`` against
    the JAX package's ``_dropout_keep`` over each bucket's (row + start,
    slot lane) positions, from the JAX package's own seeds."""
    _, tb = _batches(seed=3)
    spec = ell.EllSpec.from_hint(tb.graph.ell_hint)
    ch = TOWERS * C_IN
    for seed in _jax_seeds(jax.random.PRNGKey(7), 1 if parity else 4):
        for s, b, w in zip(spec.starts, spec.bounds, spec.widths):
            rows = jax.lax.broadcasted_iota(jnp.int32, (b - s, w * ch), 0) + jnp.int32(s)
            lanes = jax.lax.broadcasted_iota(jnp.int32, (b - s, w * ch), 1)
            want = jax_dropout_keep(jnp.int32(seed), rows, lanes, 0.5)
            got = dropout_keep(torch.tensor([seed], dtype=torch.int32),
                               torch.arange(s, b)[:, None], torch.arange(w * ch)[None, :], 0.5)
            _equal(want, got, f"mask rows [{s}, {b})")


@pytest.mark.parametrize("route", ["ell", "csr"])
def test_synthetic_edges_move_nothing(route):
    """The degree-exact layout's bucket-padding rows carry masked
    self-loops. Filling those edges' features with 1e6 moves no real output
    and no gradient (bit-equal), on the ELL route and on the CSR routes
    (``csr``: min/max through kernels 6-7's plain versions, the PNA set
    through 1, 4, 5 and 8's), with dropout on where the route hashes it."""
    _, tb = _batches(seed=4)
    g = tb.graph
    syn = ~g.edge_mask & (g.dst < g.n_node - 1)
    assert int(syn.sum()) > 0
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randn(g.n_node, C_IN).astype(np.float32))
    e0 = torch.from_numpy(rs.randn(g.n_edge, EDGE_DIM).astype(np.float32))
    e_big = torch.where(syn[:, None], 1e6, e0)
    ct = torch.from_numpy(rs.randn(g.n_node, C_IN).astype(np.float32))
    for aggs in AGG_SETS:
        conv = _conv_pair(aggs, False, route)[2]
        runs = []
        for e in (e0, e_big):
            conv.zero_grad(set_to_none=True)
            tx = x.clone().requires_grad_(True)
            te = e.clone().requires_grad_(True)
            seeds = [5, 6, 7, 8][:len(aggs)] if route == "ell" else None
            out = conv(tx, g, te, seed=seeds)
            (torch.where(g.node_mask[:, None], out, 0.0) * ct).sum().backward()
            runs.append((out[g.node_mask], tx.grad[g.node_mask], te.grad[g.edge_mask],
                         [p.grad for p in conv.parameters()]))
        (o0, gx0, ge0, gp0), (o1, gx1, ge1, gp1) = runs
        assert torch.equal(o0, o1) and torch.equal(gx0, gx1) and torch.equal(ge0, ge1)
        for a, b in zip(gp0, gp1):
            assert (a is None and b is None) or torch.equal(a, b)


def test_gather_by_src_exact_csc_matches_kernel_1():
    """``gather_by_src``'s VJP on a ``csc_ell_exact`` graph (the lane sums)
    against kernel 1's plain version over the CSC of the same graph, and
    against the JAX package's ``_csc_exact_segment_sum``: bit-equal on the
    real rows (slot by slot in CSC order, both)."""
    from mma_tpu.ops.gather import _csc_exact_segment_sum

    jb, tb = _batches(seed=5)
    g = tb.graph
    rs = np.random.RandomState(3)
    x = torch.tensor(rs.randn(g.n_node, 7).astype(np.float32), requires_grad=True)
    ct = rs.randn(g.n_edge, 7).astype(np.float32) * g.edge_mask.numpy()[:, None]
    gather_by_src(x, g).backward(torch.from_numpy(ct))
    plain = dataclasses.replace(g, csc_ell_exact=False)
    x2 = x.detach().clone().requires_grad_(True)
    gather_by_src(x2, plain).backward(torch.from_numpy(ct))
    m = g.node_mask
    assert torch.equal(x.grad[m], x2.grad[m])
    want = np.asarray(_csc_exact_segment_sum(jnp.asarray(ct), jb.graph))
    np.testing.assert_array_equal(x.grad.numpy(), want)


# -------------------------------------------------------------- ZincNet

def _net_pair(aggs, parity, remat=False):
    jnet = JaxZincNet(aggregators=aggs, scalers=("identity", "amplification", "linear"),
                      avg_deg=tuple(AVG_DEG.items()), parity=parity, max_degree_hint=4,
                      **SMALL_NET)
    params, state = jnet.init(jax.random.PRNGKey(2)), jnet.init_state()
    net = ZincNet(aggs, ("identity", "amplification", "linear"), AVG_DEG, parity=parity,
                  remat=remat, max_degree_hint=4, device="cpu", **SMALL_NET)
    zinc_net_from_jax(_np(params), _np(state), net)
    return jnet, params, state, net


def _layer_seeds(rng, parity, n_aggs):
    """Per-layer ELL seeds of ``ZincNet.apply(rng=rng)``: ``split(rng, L)``
    per layer (``mma_tpu/models/zinc_net.py:128``), then the conv's."""
    return [_jax_seeds(k, 1 if parity else n_aggs)
            for k in jax.random.split(rng, SMALL_NET["num_layers"])]


@pytest.mark.parametrize("aggs,parity", [(("mean", "min", "max", "std"), True),
                                         (("mean", "max", "min"), False)])
def test_zinc_net_on_degree_ordered_batches_matches_jax(aggs, parity):
    """A training forward of the whole model on a degree-ordered batch (the
    pool through kernel 1's index form): the PNA set under parity and the
    command line's default set in fixed mode (``min,max`` under parity is
    :func:`test_degree_exact_adam_steps_match_jax`'s), with dropout on from
    the JAX package's seeds (the convs' dropout-off paths are
    :func:`test_conv_matches_jax`'s): predictions within 1e-5, the loss
    within 1e-5 relative, every gradient within 2e-5 of its tensor's
    largest value (BatchNorm-fed biases against the conv's ``lin.w``
    scale, as ``tests/test_torch_zinc_net.py`` holds them; with std in the
    set plus four times the port's own change when the embedding tables
    move by one ulp, that file's allowance), BatchNorm state within 1e-5."""
    jb, tb = _batches(seed=6)
    jnet, params, state, _ = _net_pair(aggs, parity)
    rng = jax.random.PRNGKey(9)
    seeds = _layer_seeds(rng, parity, len(aggs))

    def jloss(p):
        pred, new_state = jnet.apply(p, state, jb, training=True, rng=rng, use_pallas=True)
        gm = jb.graph_mask.astype(pred.dtype)
        return jnp.sum(jnp.abs(pred - jb.target) * gm) / jnp.sum(gm), (pred, new_state)

    def port(nudge=False):
        net = _net_pair(aggs, parity)[3]
        if nudge:
            with torch.no_grad():
                for table in (net.node_emb.table, net.edge_emb.table):
                    table.copy_(torch.nextafter(table, torch.tensor(np.inf)))
        pred = net(tb, training=True, seeds=seeds)
        loss = l1_loss(pred, tb)
        loss.backward()
        return net, pred.detach().numpy(), float(loss.detach())

    (jl, (jpred, jstate)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    net, pred, loss = port()
    gm = np.asarray(jb.graph_mask)
    np.testing.assert_allclose(pred[gm], np.asarray(jpred)[gm], rtol=1e-5, atol=1e-5)
    assert loss == pytest.approx(float(jl), rel=1e-5)
    got_g = _grad_tree(net, lambda m: zinc_net_to_numpy(m)[0])
    want_g = _np(jgrads)
    slack = None
    if "std" in aggs:
        g1 = _grad_tree(port(nudge=True)[0], lambda m: zinc_net_to_numpy(m)[0])
        slack = jax.tree.map(lambda a, b: 4 * np.abs(a - b).max(), got_g, g1)
    for i in range(SMALL_NET["num_layers"]):
        scale = np.abs(want_g[f"conv{i}"]["lin"]["w"]).max()
        allow = 0.0 if slack is None else max(_pop_bn_fed_biases(slack[f"conv{i}"]))
        for tree in (got_g, want_g):
            for b in _pop_bn_fed_biases(tree[f"conv{i}"]):
                assert np.abs(b).max() <= 2e-5 * scale + allow
    _assert_trees_close(got_g, want_g, "grad", rel=2e-5, slack=slack)
    _assert_trees_close(zinc_net_to_numpy(net)[1], _np(jstate), "state")


@pytest.mark.parametrize("aggs,exact", [(("min", "max"), False), (("mean", "max", "min"), False),
                                        (("min", "max"), True)],
                         ids=["fused", "general", "ell"])
def test_remat_gradients_are_bit_equal(aggs, exact):
    """``remat=True`` against ``remat=False``, dropout on from one generator
    seed: 2 train steps' gradients, BatchNorm buffers and the generator's
    state after them bit-equal, on the fused (kernels 6-7), general
    (kernels 1, 4, 5; ``torch.Generator`` masks) and ELL routes. The
    recompute redraws the same masks from a copy of the generator state."""
    _, tb = _batches(seed=8, exact=exact)
    outs = []
    for remat in (False, True):
        net = _net_pair(aggs, True, remat=remat)[3]
        opt = make_optimizer(net.parameters(), 1e-3, 3e-4)
        gen = torch.Generator().manual_seed(4)
        grads = []
        for _ in range(2):
            opt.zero_grad(set_to_none=True)
            l1_loss(net(tb, training=True, generator=gen), tb).backward()
            grads.append([p.grad.clone() if p.grad is not None else None
                          for p in net.parameters()])
            opt.step()
        outs.append((grads, [b.clone() for b in net.buffers()], gen.get_state()))
    (g0, b0, s0), (g1, b1, s1) = outs
    for step0, step1 in zip(g0, g1):
        for a, b in zip(step0, step1):
            assert (a is None and b is None) or torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(b0, b1)) and torch.equal(s0, s1)


# ---------------------------------------------------------- the training

def test_zinc_layout_pads_as_the_jax_loop():
    """``zinc_layout``: the pads and budgets of ``mma_tpu/train/loops.py:
    224-271`` per ``batch_layout`` and ``edge_format``, with the port's
    ``"auto"`` rule (the degree-exact collate only with
    ``edge_format="ell"``; the JAX package's takes it unless
    ``edge_format="csr"``)."""
    splits = [load_zinc(s, subset_size=120) for s in ("train", "val", "test")]
    for kw in (dict(), dict(edge_format="ell"), dict(edge_format="ell", batch_size=16),
               dict(batch_layout="degree_exact", edge_format="csr"), dict(edge_format="csr"),
               dict(batch_layout="plain", edge_format="ell")):
        cfg = ZincConfig(**kw)
        n_node, n_edge, budgets = zinc_layout(cfg, splits)

        def top(values):
            return int(np.sort(np.asarray(values))[::-1][:cfg.batch_size].sum())

        want_n = min(-(-(1 + max(top(d.num_nodes) for d in splits)) // 256) * 256,
                     cfg.batch_size * cfg.n_node_per_graph)
        want_e = min(-(-max(top([len(s) for s in d.edge_src]) for d in splits) // 256) * 256,
                     cfg.batch_size * cfg.n_edge_per_graph)
        if cfg.batch_layout == "degree_exact" or (cfg.batch_layout == "auto"
                                                  and cfg.edge_format == "ell"):
            bz = [jax_degree_budgets([int(n) for n in d.num_nodes], d.edge_src, d.edge_dst,
                                     cfg.batch_size, worst_case=True, include_zero=True)
                  for d in splits]
            w = max(len(b) for b, _ in bz)
            want_b = tuple(max(b[i] if i < len(b) else 0 for b, _ in bz) for i in range(w))
            rows = sum(want_b) + max(z for _, z in bz) + 1
            slots = sum(b * (i + 1) for i, b in enumerate(want_b))
            want_n, want_e = max(want_n, -(-rows // 256) * 256), max(want_e, -(-slots // 256) * 256)
        else:
            want_b = None
        assert (n_node, n_edge, budgets) == (want_n, want_e, want_b), kw
    with pytest.raises(ValueError, match="batch_layout"):
        zinc_layout(ZincConfig(batch_layout="sorted"), splits)


def test_degree_exact_adam_steps_match_jax():
    """3 Adam steps (lr 1e-3, weight decay 3e-4) of the degree-exact
    training step on the batches ``train_zinc(batch_layout="degree_exact")``
    collates (its budgets and pads, the first 3 shuffled batches of epoch
    0), dropout on with the JAX package's seeds: the loss of every step
    within 1e-5 relative, and after 3 steps every parameter within 1e-5
    where the step-1 gradient exceeds 1e-3 of its tensor's largest (within
    2·lr·steps elsewhere: Adam divides rounding-noise gradients by √v) and
    the BatchNorm state within 1e-4 of its largest value, the rule of
    ``tests/test_torch_zinc_net.py``'s Adam test; each running mean also
    within the change of the BatchNorm-fed biases' shift of its input."""
    cfg = ZincConfig(batch_size=16, batch_layout="degree_exact", **{
        k: v for k, v in SMALL_NET.items()})
    splits = {s: load_zinc(s, subset_size=48) for s in ("train", "val", "test")}
    n_node, n_edge, budgets = zinc_layout(cfg, list(splits.values()))
    kw = dict(n_node=n_node, n_edge=n_edge, shuffle=True, seed=cfg.seed,
              ell_degree_budgets=budgets)
    jbs = list(jax_load_zinc("train", subset_size=48).batches(16, **kw))
    tbs = list(splits["train"].batches(16, device="cpu", **kw))
    aggs = ("min", "max")
    jnet, params, state, net = _net_pair(aggs, True)
    lr, wd = 1e-3, 3e-4
    opt = jax_make_optimizer(lr, wd)
    opt_state = opt.init(params)
    topt = make_optimizer(net.parameters(), lr, wd)
    grads1 = None
    @jax.jit
    def jstep(p, s, jb, rng):
        def jloss(p_):
            pred, new_state = jnet.apply(p_, s, jb, training=True, rng=rng, use_pallas=True)
            gm = jb.graph_mask.astype(pred.dtype)
            return jnp.sum(jnp.abs(pred - jb.target) * gm) / jnp.sum(gm), new_state

        return jax.value_and_grad(jloss, has_aux=True)(p)

    for step, (jb, tb) in enumerate(zip(jbs, tbs)):
        rng = jax.random.PRNGKey(100 + step)
        (jl, state), jg = jstep(params, state, jb, rng)
        updates, opt_state = opt.update(jg, opt_state, params)
        params = optax.apply_updates(params, updates)
        topt.zero_grad(set_to_none=True)
        loss = l1_loss(net(tb, training=True, seeds=_layer_seeds(rng, True, 2)), tb)
        loss.backward()
        for p in net.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        topt.step()
        assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5), step
        if step == 0:
            grads1 = _np(jg)
    assert len(tbs) == 3
    got, got_state = zinc_net_to_numpy(net)
    for (path, w), g, g1 in zip(jax.tree_util.tree_flatten_with_path(_np(params))[0],
                                jax.tree.leaves(got), jax.tree.leaves(grads1)):
        name = jax.tree_util.keystr(path)
        diff = np.abs(g - w)
        sure = np.abs(g1) > 1e-3 * np.abs(g1).max()
        if name.endswith("['b']") and ("['lin']" in name or "post_nns" in name):
            sure[:] = False  # a BatchNorm-fed bias: rounding-noise gradient
        assert diff[sure].max(initial=0.0) <= 1e-5, name
        assert diff.max() <= 2 * lr * 3, name
    # The BatchNorm-fed biases shift each BN input by a constant per
    # channel, which the running means average: they may differ by the
    # largest change of that shift.
    want = _np(params)
    slack = jax.tree.map(lambda a: 0.0, got_state)
    for i in range(SMALL_NET["num_layers"]):
        g_c, w_c = got[f"conv{i}"], want[f"conv{i}"]
        d_post = np.concatenate([tg[-1]["b"] - tw[-1]["b"]
                                 for tg, tw in zip(g_c["post_nns"], w_c["post_nns"])])
        shift = np.abs(d_post @ w_c["lin"]["w"] + g_c["lin"]["b"] - w_c["lin"]["b"])
        slack[f"bn{i}"]["mean"] = shift.max()
    _assert_trees_close(got_state, _np(state), "state", rel=1e-4, slack=slack)
