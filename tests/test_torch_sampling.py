"""The port's sampled-training slice against the JAX package, on the CPU.

Covers ``mma_tpu_torch.data.sampling`` (the sampler bit for bit on both
backends and both layouts, its errors), ``graph.device_build``
(``finish_graph_on_device`` field for field), the node-classification ELL
route of ``masked_multi_aggregate`` and the ELL branch of ``binary_spmm``,
full-fanout exactness, ``train.sampled`` (Adam steps, the producer, the
device tables), the sampled-against-full accuracy check and the CLI.

Inputs come from numpy seeds. The JAX side runs as ``tests/test_ell.py``
and ``tests/test_sampling.py`` run it: the ELL route with
``use_pallas=True``, whose Pallas kernels (the CSC sum of the slot
gather's VJP, the CSR spmm) run in interpret mode. Tolerances are stated in
each test.
"""

import dataclasses
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mma_tpu.data.sampling import NeighborSampler as JaxNeighborSampler
from mma_tpu.graph.build import graph_from_edges as jax_graph_from_edges
from mma_tpu.graph.device_build import finish_graph_on_device as jax_finish_graph_on_device
from mma_tpu.models import NodeClassifier as JaxNodeClassifier
from mma_tpu.nn.mma_layer import MMALayer as JaxMMALayer
from mma_tpu.ops.spmm import binary_spmm as jax_binary_spmm
from mma_tpu.train.sampled import DeviceTableAssembler as JaxDeviceTableAssembler
from mma_tpu.train.sampled import SampledTrainConfig as JaxSampledTrainConfig
from mma_tpu.train.sampled import sampled_batch_producer as jax_sampled_batch_producer
from mma_tpu.train.sampled import train_sampled as jax_train_sampled

from mma_tpu_torch import MMALayer, NodeClassifier, graph_from_edges
from mma_tpu_torch.cli import train_sampled as cli
from mma_tpu_torch.convert import node_classifier_from_jax
from mma_tpu_torch.data.sampling import NeighborSampler
from mma_tpu_torch.graph.device_build import finish_graph_on_device
from mma_tpu_torch.ops import binary_spmm, get_agg_spec, masked_multi_aggregate
from mma_tpu_torch.train import make_optimizer, sampled as sampled_mod
from mma_tpu_torch.train.sampled import (
    DeviceTableAssembler,
    SampledTrainConfig,
    sampled_batch_producer,
    train_sampled,
)

FIELDS = ("src", "dst", "edge_mask", "node_mask", "deg", "row_ptr", "src_perm", "col_ptr",
          "src_csc", "dst_csc")
FANOUTS = (4, 4, 3)
HOP_PADS = (32, 160, 768, 2048)
PADS = dict(n_node_pad=4096, n_edge_pad=4096)


def _edges(n=3000, m=24000, seed=0):
    """``tests/test_ell.py``'s sampler graph: a random symmetric COO."""
    rs = np.random.RandomState(seed)
    a = rs.randint(0, n, m).astype(np.int32)
    b = rs.randint(0, n, m).astype(np.int32)
    keep = a != b
    return np.concatenate([a[keep], b[keep]]), np.concatenate([b[keep], a[keep]]), n, rs


def _samplers(seed=1, use_native=True, fanouts=FANOUTS):
    src, dst, n, rs = _edges()
    seeds = rs.choice(n, 32, replace=False)
    mk_t = lambda: NeighborSampler.from_host_arrays(src, dst, n, fanouts, seed=seed,  # noqa: E731
                                                    use_native=use_native, device="cpu")
    mk_j = lambda: JaxNeighborSampler.from_host_arrays(src, dst, n, fanouts, seed=seed,  # noqa: E731
                                                       use_native=use_native)
    return mk_t, mk_j, seeds, n


def _assert_graph_equal(tg, jg, what=""):
    for f in FIELDS:
        got, want = getattr(tg, f).numpy(), np.asarray(getattr(jg, f))
        assert got.dtype == want.dtype, f"{what}{f}: {got.dtype} != {want.dtype}"
        np.testing.assert_array_equal(got, want, err_msg=f"{what}{f}")
    assert tg.ell_hint == jg.ell_hint


def _assert_batch_equal(tb, jb, what=""):
    np.testing.assert_array_equal(tb.node_ids, np.asarray(jb.node_ids))
    assert tb.node_ids.dtype == np.asarray(jb.node_ids).dtype
    assert (tb.num_seeds, tb.num_nodes) == (jb.num_seeds, jb.num_nodes)
    _assert_graph_equal(tb.graph, jb.graph, what)


def _assert_arrays_equal(ta, ja):
    for f in ("src", "dst", "node_ids", "src_perm"):
        got, want = getattr(ta, f), getattr(ja, f)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (ta.num_edges, ta.num_seeds, ta.num_nodes, ta.ell_hint) == \
        (ja.num_edges, ja.num_seeds, ja.num_nodes, ja.ell_hint)


# ------------------------------------------------------------------ sampler

@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("hop_pads", [None, HOP_PADS], ids=["plain", "hopped"])
def test_sampler_matches_jax_bit_for_bit(use_native, hop_pads):
    """Two ``sample`` then two ``sample_arrays`` calls from one sampler
    each: every field exactly equal to the JAX sampler's with the same seed
    and backend, so the random streams stay in step across calls."""
    mk_t, mk_j, seeds, n = _samplers(use_native=use_native)
    ts, js = mk_t(), mk_j()
    np.testing.assert_array_equal(ts.true_deg, js.true_deg)
    for i in range(2):
        s = (seeds + 97 * i) % n
        _assert_batch_equal(ts.sample(s, hop_node_pads=hop_pads, **PADS),
                            js.sample(s, hop_node_pads=hop_pads, **PADS), f"sample {i} ")
    for i in range(2):
        s = (seeds + 31 * i) % n
        _assert_arrays_equal(ts.sample_arrays(s, hop_node_pads=hop_pads, **PADS),
                             js.sample_arrays(s, hop_node_pads=hop_pads, **PADS))
    if hop_pads is not None:
        assert ts.sample(seeds, hop_node_pads=hop_pads, **PADS).graph.ell_hint == \
            ((32, 4), (192, 4), (960, 3))


def test_sampler_from_a_graph_and_its_batches_match_jax():
    """The ``Graph`` constructor and ``batches`` (shuffled seed order, the
    structural pads): the same batches as the JAX sampler's, covering the
    seed set; seeds occupy the first rows; every seed's in-degree is at
    most its fanout (``tests/test_sampling.py:16-70``)."""
    rs = np.random.RandomState(4)
    n = 100
    src, dst = rs.randint(0, n, 600).astype(np.int32), rs.randint(0, n, 600).astype(np.int32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    ts = NeighborSampler(graph_from_edges(src, dst, n, device="cpu"), (3,), seed=5, device="cpu")
    js = JaxNeighborSampler(jax_graph_from_edges(src, dst, n), (3,), seed=5)
    seen = []
    tbs = list(ts.batches(np.arange(50), 16, n_node_pad=256, n_edge_pad=1024))
    jbs = list(js.batches(np.arange(50), 16, n_node_pad=256, n_edge_pad=1024))
    assert len(tbs) == len(jbs) == 4
    for tb, jb in zip(tbs, jbs):
        _assert_batch_equal(tb, jb)
        seen.extend(tb.node_ids[: tb.num_seeds].tolist())
        e_mask = tb.graph.edge_mask.numpy()
        dst_l = tb.graph.dst.numpy()[e_mask]
        assert tb.graph.src.numpy()[e_mask].max() < tb.num_nodes
        assert np.bincount(dst_l, minlength=tb.num_seeds)[: tb.num_seeds].max() <= 3
    assert sorted(seen) == list(range(50))


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("case", ["hop_budget", "hop_count", "node_pad", "edge_pad"])
def test_sampler_errors_match_jax(use_native, case):
    """Overflows raise ValueError in both packages (``tests/test_ell.py:319-327``):
    a hop over its budget (``sample`` and ``sample_arrays``), a wrong number
    of hop budgets, a node pad or an edge pad too small."""
    mk_t, mk_j, seeds, _ = _samplers(use_native=use_native)
    calls = {
        "hop_budget": [("sample", dict(hop_node_pads=(32, 4, 768, 2048), **PADS)),
                       ("sample_arrays", dict(hop_node_pads=(32, 4, 768, 2048), **PADS))],
        "hop_count": [("sample", dict(hop_node_pads=(32, 160, 768), **PADS)),
                      ("sample_arrays", dict(hop_node_pads=(32, 160, 768), **PADS))],
        "node_pad": [("sample_arrays", dict(n_node_pad=64, n_edge_pad=4096))],
        "edge_pad": [("sample_arrays", dict(n_node_pad=4096, n_edge_pad=64))],
    }[case]
    for method, kw in calls:
        for mk in (mk_t, mk_j):
            with pytest.raises(ValueError):
                getattr(mk(), method)(seeds, **kw)


# ---------------------------------------------------------- device finishing

@pytest.mark.parametrize("hop_pads,emit_csc", [(None, True), (None, False), (HOP_PADS, True)])
def test_finished_graph_matches_host_built_and_jax(hop_pads, emit_csc):
    """``sample_arrays`` + ``finish_graph_on_device`` reproduces the
    host-built graph field for field (``tests/test_sampling.py:199-258``),
    and the JAX package's finished graph; without the host CSC permutation
    the stable argsort gives the same one."""
    mk_t, mk_j, seeds, _ = _samplers(seed=2)
    kw = dict(hop_node_pads=hop_pads, **PADS)
    host = mk_t().sample(seeds, **kw)
    arr = mk_t().sample_arrays(seeds, emit_csc=emit_csc, **kw)
    jarr = mk_j().sample_arrays(seeds, emit_csc=emit_csc, **kw)
    assert (arr.src_perm is not None) == emit_csc
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    deg_table = torch.from_numpy(mk_t().true_deg)
    dev = finish_graph_on_device(t(arr.src), t(arr.dst), t(arr.node_ids), arr.num_edges,
                                 deg_table, t(arr.src_perm), ell_hint=arr.ell_hint)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    jdev = jax_finish_graph_on_device(j(jarr.src), j(jarr.dst), j(jarr.node_ids),
                                      jnp.int32(jarr.num_edges), jnp.asarray(mk_j().true_deg),
                                      j(jarr.src_perm), ell_hint=jarr.ell_hint)
    _assert_graph_equal(dev, jdev, "vs jax: ")
    for f in FIELDS:
        torch.testing.assert_close(getattr(dev, f), getattr(host.graph, f), rtol=0, atol=0)
    assert dev.ell_hint == host.graph.ell_hint
    np.testing.assert_array_equal(arr.node_ids, host.node_ids.astype(np.int32))


# ----------------------------------------------------------- the ELL route

@pytest.fixture(scope="module")
def hopped():
    """One hopped batch of the sampler graph from both packages (equal,
    checked), and node features for it."""
    mk_t, mk_j, seeds, n = _samplers()
    tb = mk_t().sample(seeds, hop_node_pads=HOP_PADS, **PADS)
    jb = mk_j().sample(seeds, hop_node_pads=HOP_PADS, **PADS)
    _assert_batch_equal(tb, jb)
    feats = np.random.RandomState(2).randn(n, 16).astype(np.float32)
    x = np.zeros((tb.graph.n_node, 16), np.float32)
    valid = tb.node_ids >= 0
    x[valid] = feats[tb.node_ids[valid]]
    return tb, jb, x


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


@pytest.mark.parametrize("aggs,parity", [
    (("mean", "mean2"), True),
    (("min", "min2", "min3", "min4"), True),
    (("std", "normalized_mean", "moment_3"), False),
])
def test_mma_layer_ell_route_matches_jax_and_the_csr_route(hopped, aggs, parity):
    """``MMALayer`` on a hopped batch: loss, output and every gradient
    (parameters and input) against the JAX ELL route (``use_pallas=True``)
    within 2e-4 of each tensor's largest value, ``tests/test_ell.py``'s
    bound between its ELL and XLA routes, and against the port's CSR route
    on the same graph without the hint within 1e-4 (float32 sums in
    another order; std and moment_3 amplify them)."""
    tb, jb, x16 = hopped
    x = x16[:, :10]
    layer = JaxMMALayer(10, 10, aggs, parity=parity)
    params = layer.init(jax.random.PRNGKey(1))
    mask = np.asarray(jb.graph.node_mask)[:, None]

    def jloss(p, xx):
        out = layer.apply(p, xx, jb.graph, use_pallas=True)
        return jnp.sum(jnp.where(mask, out, 0.0) ** 2), out

    (jl, jout), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))

    def port(graph):
        tl = MMALayer(10, 10, aggs, parity=parity, device="cpu")
        with torch.no_grad():
            for name in ("w", "masks", "b"):
                getattr(tl, name).copy_(torch.from_numpy(np.array(params[name])))
        tx = torch.from_numpy(x).requires_grad_()
        out = tl(tx, graph)
        loss = torch.where(torch.from_numpy(mask), out, 0.0).pow(2).sum()
        loss.backward()
        return loss.item(), out.detach(), {n_: p.grad for n_, p in tl.named_parameters()}, tx.grad

    tl_, tout, tgp, tgx = port(tb.graph)
    assert abs(tl_ - float(jl)) <= 2e-4 * max(abs(float(jl)), 1.0)
    assert _rel_err(tout.numpy() * mask, np.asarray(jout) * mask) < 2e-4
    assert _rel_err(tgx, jgx) < 2e-4
    for name in ("w", "masks", "b"):
        assert _rel_err(tgp[name], jgp[name]) < 2e-4, name
    cl, cout, cgp, cgx = port(dataclasses.replace(tb.graph, ell_hint=None))
    assert abs(tl_ - cl) <= 1e-4 * max(abs(cl), 1.0)
    assert _rel_err(tout.numpy() * mask, cout.numpy() * mask) < 1e-4
    assert _rel_err(tgx, cgx) < 1e-4
    for name in ("w", "masks", "b"):
        assert _rel_err(tgp[name], cgp[name]) < 1e-4, name


def test_node_classifier_on_a_hopped_batch_matches_jax(hopped):
    """``NodeClassifier`` forward (seed rows) and every parameter gradient of
    the seed NLL on a hopped batch, against the JAX ``use_pallas=True``
    route from the same weights: within 2e-4 of each tensor's largest
    value; the port's ELL and CSR routes within 1e-5."""
    tb, jb, x = hopped
    ns = tb.num_seeds
    labels = np.random.RandomState(3).randint(0, 3, tb.graph.n_node)
    jmodel = JaxNodeClassifier(n_feat=16, n_hidden=8, n_class=3, aggregators=("mean", "mean2"),
                               dropout_rate=0.0)
    params = jmodel.init(jax.random.PRNGKey(0))

    def jloss(p):
        logp = jmodel.apply(p, jnp.asarray(x), jb.graph, use_pallas=True)
        return -jnp.mean(logp[jnp.arange(ns), labels[:ns]]), logp

    (_, jlogp), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)

    def port(graph):
        model = NodeClassifier(16, 8, 3, ("mean", "mean2"), dropout_rate=0.0, device="cpu")
        node_classifier_from_jax(jax.tree.map(np.asarray, params), model)
        logp = model(torch.from_numpy(x), graph)
        (-logp[torch.arange(ns), torch.from_numpy(labels[:ns])].mean()).backward()
        return logp.detach(), {n_: p.grad for n_, p in model.named_parameters()}

    tlogp, tgrads = port(tb.graph)
    assert _rel_err(tlogp[:ns], np.asarray(jlogp)[:ns]) < 2e-4
    for layer in ("gc1", "mma"):
        for p, want in jgrads[layer].items():
            assert _rel_err(tgrads[f"{layer}.{p}"], want) < 2e-4, f"{layer}.{p}"
    clogp, cgrads = port(dataclasses.replace(tb.graph, ell_hint=None))
    assert _rel_err(tlogp[:ns], clogp[:ns]) < 1e-5
    for name, g in tgrads.items():
        assert _rel_err(g, cgrads[name]) < 1e-5, name


def test_ell_route_hole_rows_move_nothing(hopped):
    """Hop holes and padding rows have no edges: a 1e6 in their features
    moves no seed output, and their input gradient is 0, bit for bit, on
    the ELL route with mask dropout (generator seeded) and without."""
    tb, _, x = hopped
    ns = tb.num_seeds
    holes = ~tb.graph.node_mask.numpy()
    assert holes[: tb.graph.ell_hint[-1][0]].any()  # holes inside the hop ranges
    model = NodeClassifier(16, 8, 3, ("mean", "mean2"), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    for training in (False, True):
        outs = []
        for fill in (0.0, 1e6):
            xx = x.copy()
            xx[holes] = fill
            tx = torch.from_numpy(xx).requires_grad_()
            out = model(tx, tb.graph, training=training,
                        generator=torch.Generator().manual_seed(7))
            out[:ns].sum().backward()
            assert not tx.grad[torch.from_numpy(holes)].any()
            outs.append(out[:ns].detach())
        torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_ell_route_mask_dropout_is_seeded(hopped):
    """Mask dropout on the ELL route draws from the caller's generator: the
    same seed gives the same output bit for bit, another seed another
    output, and rate 0 the deterministic one."""
    tb, _, x = hopped
    h = torch.from_numpy(x[:, :8])
    specs = [get_agg_spec(a) for a in ("mean", "mean2")]
    mw = torch.from_numpy(np.random.RandomState(5).randn(2, 16, 8).astype(np.float32) / 4)

    def run(seed, rate=0.5):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return masked_multi_aggregate(h, tb.graph, mw, specs, mask_dropout_rate=rate,
                                      generator=gen)

    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.equal(run(3), run(4))
    assert not torch.equal(run(3), run(None))
    torch.testing.assert_close(run(3, rate=0.0), run(None), rtol=0, atol=0)


def test_degree_exact_layout_is_refused():
    g = graph_from_edges(np.array([0, 1], np.int32), np.array([1, 0], np.int32), 2,
                         device="cpu")
    g = dataclasses.replace(g, ell_hint=((2, 1),), ell_exact=True)
    h = torch.zeros(g.n_node, 4)
    with pytest.raises(ValueError, match="degree-exact"):
        masked_multi_aggregate(h, g, torch.zeros(1, 8, 4), [get_agg_spec("mean")])


def test_binary_spmm_ell_branch_matches_jax_and_the_csr_path(hopped):
    """The ELL branch (a hopped graph without its CSC): forward and the
    gradient of ``sum(out²)`` against the JAX ELL branch
    (``tests/test_ell.py:240-255``) and the port's CSR path on the graph
    with its CSC, within 1e-5 of each tensor's largest value."""
    tb, jb, x = hopped
    strip = dict(src_perm=None, col_ptr=None, src_csc=None, dst_csc=None)
    tg, jg = dataclasses.replace(tb.graph, **strip), dataclasses.replace(jb.graph, **strip)
    jx = jnp.asarray(x)
    want = jax_binary_spmm(jg, jx, use_pallas=True)
    jgrad = jax.grad(lambda v: jnp.sum(jax_binary_spmm(jg, v, use_pallas=True) ** 2))(jx)
    grads = {}
    for name, graph in (("ell", tg), ("csr", tb.graph)):
        tx = torch.from_numpy(x).requires_grad_()
        out = binary_spmm(graph, tx)
        out.pow(2).sum().backward()
        grads[name] = (out.detach(), tx.grad)
    mask = tb.graph.node_mask.numpy()[:, None]
    assert _rel_err(grads["ell"][0].numpy() * mask, np.asarray(want) * mask) < 1e-5
    assert _rel_err(grads["ell"][1], jgrad) < 1e-5
    assert _rel_err(grads["ell"][0], grads["csr"][0]) < 1e-5
    assert _rel_err(grads["ell"][1], grads["csr"][1]) < 1e-5


# -------------------------------------------------------- full-fanout exactness

@pytest.mark.parametrize("hop_pads", [None, (4, 80, 80, 80)], ids=["plain", "hopped"])
def test_full_fanout_exact_on_seeds(hop_pads):
    """At fanout ≥ the largest degree over the three hops the model's
    receptive field, the seeds' outputs on the sample equal the full-graph
    outputs (``tests/test_sampling.py:33-61``, rtol = atol = 2e-4), on the
    plain layout (the CSR routes) and the hopped one (the ELL route)."""
    rs = np.random.RandomState(2)
    n = 80
    a = np.triu((rs.rand(n, n) < 0.1).astype(np.float32), 1)
    a = a + a.T
    for i in range(n):
        if a[i].sum() == 0:
            j = (i + 1) % n
            a[i, j] = a[j, i] = 1.0
    dst, src = np.nonzero(a)
    g = graph_from_edges(src.astype(np.int32), dst.astype(np.int32), n, device="cpu")
    x_full = np.zeros((g.n_node, 12), np.float32)
    x_full[:n] = rs.randn(n, 12)
    model = NodeClassifier(12, 16, 5, ("mean", "sum2", "min"), dropout_rate=0.0, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        full_out = model(torch.from_numpy(x_full), g).numpy()
    max_deg = int(g.deg.max())
    sampler = NeighborSampler(g, (max_deg,) * 3, seed=3, device="cpu")
    seeds = np.asarray([3, 17, 42, 79])
    batch = sampler.sample(seeds, n_node_pad=400, n_edge_pad=4096, hop_node_pads=hop_pads)
    x_sub = np.zeros((batch.graph.n_node, 12), np.float32)
    valid = batch.node_ids >= 0
    x_sub[valid] = x_full[batch.node_ids[valid]]
    with torch.no_grad():
        sub_out = model(torch.from_numpy(x_sub), batch.graph).numpy()
    np.testing.assert_allclose(sub_out[: len(seeds)], full_out[seeds], rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------------ training

def _small_graph(n=300, seed=4):
    rs = np.random.RandomState(seed)
    src, dst = rs.randint(0, n, 2400).astype(np.int32), rs.randint(0, n, 2400).astype(np.int32)
    keep = src != dst
    src, dst = np.concatenate([src[keep], dst[keep]]), np.concatenate([dst[keep], src[keep]])
    return src, dst, n, rs


def test_train_sampled_adam_steps_match_jax(monkeypatch):
    """Three ``train_sampled`` Adam steps (dropout 0; one 32-seed batch per
    epoch, so each epoch's loss is one step's) against the JAX
    ``train_sampled`` from the same converted weights and the same sampled
    batches. Rule, as ``test_adam_steps_match_jax`` (Adam divides by √v,
    so an element whose gradient is rounding noise can move by ±lr in
    either package): every step's loss within 1e-5 relative; parameters
    within 1e-5 where the JAX run moved them by at least 2.5·lr over the 3
    steps (a gradient of one sign throughout), within 2·lr·steps
    elsewhere."""
    src, dst, n, rs = _small_graph()
    feats = rs.randn(n, 8).astype(np.float32)
    labels = rs.randint(0, 3, n)
    cfg = dict(aggregators=("mean", "mean2"), hidden=12, lr=0.01, dropout=0.0, epochs=3,
               batch_size=32, fanouts=(4, 4, 4), n_node_pad=1024, n_edge_pad=4096, seed=0)
    jres = jax_train_sampled(JaxSampledTrainConfig(**cfg), jax_graph_from_edges(src, dst, n),
                             feats, labels, np.arange(32))
    # The JAX loop's initial weights: key → split → init (train/sampled.py:60-62).
    jmodel = JaxNodeClassifier(n_feat=8, n_hidden=12, n_class=3, aggregators=("mean", "mean2"),
                               dropout_rate=0.0)
    _, ik = jax.random.split(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, jmodel.init(ik))

    def from_jax(*args, **kwargs):
        return node_classifier_from_jax(init, NodeClassifier(*args, **kwargs))

    monkeypatch.setattr(sampled_mod, "NodeClassifier", from_jax)
    res = train_sampled(SampledTrainConfig(**cfg), graph_from_edges(src, dst, n, device="cpu"),
                        feats, labels, np.arange(32), device="cpu")
    assert [set(r) for r in res["history"]] == [set(r) for r in jres["history"]]
    np.testing.assert_allclose([r["loss"] for r in res["history"]],
                               [r["loss"] for r in jres["history"]], rtol=1e-5)
    lr, steps = cfg["lr"], 3
    for layer, tree in jax.tree.map(np.asarray, jres["params"]).items():
        for p, want in tree.items():
            diff = np.abs(res["params"][layer][p] - want)
            sure = np.abs(want - init[layer][p]) >= 2.5 * lr
            assert sure.any(), f"{layer}.{p}"
            assert diff[sure].max() <= 1e-5, f"{layer}.{p}"
            assert diff.max() <= 2 * lr * steps, f"{layer}.{p}"


def _producer_setup(seed=4):
    src, dst, n, rs = _small_graph(2000, seed)
    feats = rs.randn(n, 8).astype(np.float32)
    labels = rs.randint(0, 5, n)
    mk_t = lambda: NeighborSampler.from_host_arrays(src, dst, n, (4, 3), seed=9,  # noqa: E731
                                                    device="cpu")
    mk_j = lambda: JaxNeighborSampler.from_host_arrays(src, dst, n, (4, 3), seed=9)  # noqa: E731
    seed_batches = [rs.randint(0, n, size=(1, 16)) for _ in range(2)]
    return mk_t, mk_j, feats, labels, seed_batches


@pytest.mark.parametrize("device_finish", [False, True], ids=["host_built", "device_finish"])
@pytest.mark.parametrize("hop_pads", [None, (16, 128, 512)], ids=["plain", "hopped"])
def test_producer_matches_jax_for_one_device(device_finish, hop_pads):
    """``sampled_batch_producer`` yields, batch for batch, the JAX
    producer's one-device ``(x, graph, y, seed_mask)`` (its ``[0]``
    slices): x within 1e-6 (both copy the same float32 rows), the rest
    exactly (``tests/test_sampling.py:348-391``)."""
    mk_t, mk_j, feats, labels, seed_batches = _producer_setup()
    kw = dict(n_node_pad=2048, n_edge_pad=2048, hop_node_pads=hop_pads,
              device_finish=device_finish)
    jgot = list(jax_sampled_batch_producer(
        mk_j(), iter(seed_batches), JaxDeviceTableAssembler(feats, labels),
        deg_table=jnp.asarray(mk_j().true_deg) if device_finish else None, **kw))
    got = list(sampled_batch_producer(
        mk_t(), iter(seed_batches), DeviceTableAssembler(feats, labels, device="cpu"),
        deg_table=torch.from_numpy(mk_t().true_deg) if device_finish else None, **kw))
    assert len(got) == len(jgot) == 2
    for (x, g, y, sm), (jx, jg, jy, jsm) in zip(got, jgot):
        np.testing.assert_allclose(x.numpy(), np.asarray(jx)[0], atol=1e-6)
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy)[0])
        np.testing.assert_array_equal(sm.numpy(), np.asarray(jsm)[0])
        assert g.ell_hint == jg.ell_hint
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(jg, f))[0],
                                          err_msg=f)


def test_producer_errors_reach_the_consumer():
    """An exception in the producer thread is raised again by the consumer
    after the batches before it (a seed batch without a row for the
    producer's rank; an edge pad too small for the sample); closing the
    generator early stops the thread. Rank r of a two-device seed batch
    samples row r, as a one-device batch of that row does."""
    mk_t, _, feats, labels, seed_batches = _producer_setup()
    asm = DeviceTableAssembler(feats, labels, device="cpu")
    two_dev = np.concatenate(seed_batches)
    for rank in (0, 1):
        (x, g, y, sm), = sampled_batch_producer(mk_t(), iter([two_dev]), asm, rank=rank,
                                                n_node_pad=2048, n_edge_pad=2048)
        (wx, wg, wy, wsm), = sampled_batch_producer(mk_t(), iter([seed_batches[rank]]), asm,
                                                    n_node_pad=2048, n_edge_pad=2048)
        torch.testing.assert_close((x, y, sm), (wx, wy, wsm), rtol=0, atol=0)
        for f in FIELDS:
            torch.testing.assert_close(getattr(g, f), getattr(wg, f), rtol=0, atol=0)
    got = []
    with pytest.raises(ValueError, match="no row for rank 1"):
        for item in sampled_batch_producer(mk_t(), iter([two_dev, seed_batches[0]]), asm,
                                           rank=1, n_node_pad=2048, n_edge_pad=2048):
            got.append(item)
    assert len(got) == 1
    with pytest.raises(ValueError, match="edge"):
        list(sampled_batch_producer(mk_t(), iter(seed_batches), asm, n_node_pad=2048,
                                    n_edge_pad=8, device_finish=True,
                                    deg_table=torch.from_numpy(mk_t().true_deg)))
    gen = sampled_batch_producer(mk_t(), iter(seed_batches * 20), asm, n_node_pad=2048,
                                 n_edge_pad=2048)
    next(gen)
    gen.close()
    assert not any(t.name == "sampled-batch-producer" and t.is_alive()
                   for t in threading.enumerate())


def test_device_tables_index_modulo_their_rows():
    """A feature table smaller than the id range is read at ``max(id, 0) %
    rows`` (the CLI's hashed 65,536-row table), as the JAX assembler does;
    rows with id -1 get zeros."""
    rs = np.random.RandomState(0)
    feats = rs.randn(100, 4).astype(np.float32)
    labels = rs.randint(0, 5, 100)
    ids = np.array([5, 105, 2099, -1, 0, -1], np.int32)
    batch = type("B", (), {"node_ids": ids, "num_seeds": 2})()
    x, y, sm = DeviceTableAssembler(feats, labels, device="cpu")(batch)
    jx, jy, jsm = JaxDeviceTableAssembler(feats, labels)([batch])
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx)[0])
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy)[0])
    np.testing.assert_array_equal(sm.numpy(), np.asarray(jsm)[0])
    np.testing.assert_array_equal(x.numpy()[1], feats[5])


def test_sampled_training_accuracy_parity():
    """Partial-fanout sampled training reaches held-out accuracy within 0.08
    of full-graph training on a community graph, and full-graph training
    beats 0.6 (``tests/test_sampling.py:260-345``, the same graph,
    features, model and settings; weights and dropout from torch
    generators)."""
    rs = np.random.RandomState(3)
    n, k = 500, 4
    comm = rs.randint(0, k, n)
    edges = set()
    for i in range(n):
        for _ in range(6):
            cand = np.flatnonzero(comm == comm[i]) if rs.rand() < 0.85 else np.arange(n)
            j = int(cand[rs.randint(len(cand))])
            if i != j:
                edges.add((min(i, j), max(i, j)))
    e = np.array(sorted(edges), np.int32)
    g = graph_from_edges(np.concatenate([e[:, 0], e[:, 1]]), np.concatenate([e[:, 1], e[:, 0]]),
                         n, device="cpu")
    feats = (np.eye(k)[comm] + 1.2 * rs.randn(n, k)).astype(np.float32)
    train_idx, test_idx = np.arange(350), np.arange(350, n)
    x_full = torch.zeros(g.n_node, k)
    x_full[:n] = torch.from_numpy(feats)

    def accuracy(model):
        with torch.no_grad():
            pred = model(x_full, g).argmax(dim=1).numpy()[:n]
        return float((pred[test_idx] == comm[test_idx]).mean())

    model = NodeClassifier(k, 16, k, ("mean", "max"), dropout_rate=0.0, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model.parameters(), 0.01)
    y = torch.from_numpy(comm.astype(np.int64))
    for _ in range(60):
        opt.zero_grad()
        logp = model(x_full, g)
        (-logp[torch.from_numpy(train_idx), y[train_idx]].mean()).backward()
        opt.step()
    acc_full = accuracy(model)
    cfg = SampledTrainConfig(aggregators=("mean", "max"), hidden=16, batch_size=64,
                             fanouts=(4, 4, 4), n_node_pad=512, n_edge_pad=4096, lr=0.01,
                             dropout=0.0, epochs=12, parity=True, seed=1)
    res = train_sampled(cfg, g, feats, comm, train_idx, device="cpu")
    acc_sampled = accuracy(res["model"])
    assert acc_full > 0.6, acc_full
    assert acc_sampled > acc_full - 0.08, (acc_sampled, acc_full)


# ----------------------------------------------------------------------- CLI

TINY = ["--device", "cpu", "--nodes", "2000", "--avg-deg", "8", "--batch-size", "32",
        "--fanouts", "4,4,3", "--n-feat", "8", "--hidden", "8", "--n-class", "5",
        "--steps", "3"]


@pytest.mark.parametrize("flags", [[], ["--host-built"], ["--use-ell"], ["--sample-on-card"]],
                         ids=["device_finish", "host_built", "use_ell", "sample_on_card"])
def test_cli_runs_on_the_cpu(flags):
    """``main`` at a tiny size: finite losses, one timing record per step,
    the calibrated pads, and the same sampled edges in every mode (the
    producer modes and layouts draw the same subgraphs)."""
    res = cli.main(TINY + flags)
    assert len(res["losses"]) == len(res["records"]) == 3
    assert np.isfinite(res["losses"]).all()
    assert res["pads"]["n_node_pad"] > sum(res["pads"]["hop_node_pads"])
    assert all(r["device_ms"] is None and r["edges"] > 0 for r in res["records"])
    base = cli.main(TINY)
    assert [r["edges"] for r in res["records"]] == [r["edges"] for r in base["records"]]


def test_entry_points_default_to_the_card():
    """Without a GPU the entry points raise unless asked for the CPU; an
    unknown compute dtype raises before any set-up (``auto`` and
    ``bfloat16`` run: ``tests/test_torch_bf16_training.py``)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    src, dst, n, _ = _small_graph()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--nodes", "100"])
    with pytest.raises(RuntimeError, match="CUDA"):
        NeighborSampler.from_host_arrays(src, dst, n, (4,))
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceTableAssembler(np.zeros((4, 2), np.float32), np.zeros(4))
    with pytest.raises(RuntimeError, match="CUDA"):
        train_sampled(SampledTrainConfig(), graph_from_edges(src, dst, n, device="cpu"),
                      np.zeros((n, 2), np.float32), np.zeros(n, np.int64), np.arange(4))
    with pytest.raises(ValueError, match="compute_dtype"):
        cli.main(TINY + ["--compute-dtype", "float16"])
