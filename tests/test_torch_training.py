"""The port's training path against the JAX package, on the CPU: the
half-fused aggregation route, mask dropout, Adam steps of the node
classifier, the training loop and its command line.

Dropout streams differ between the packages (``torch.Generator`` against
``jax.random``), so parity runs with dropout off and the dropout route is
held by its own properties.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mma_tpu.graph.build import graph_from_edges as jax_graph_from_edges
from mma_tpu.models import NodeClassifier as JaxNodeClassifier
from mma_tpu.ops.aggregators import get_agg_spec as jax_get_agg_spec
from mma_tpu.ops.masked_aggregate import masked_multi_aggregate as jax_masked_multi_aggregate
from mma_tpu.train.loops import train_node_classification as jax_train_node_classification
from mma_tpu.train.optim import make_optimizer as jax_make_optimizer

from mma_tpu_torch import NodeClassifier, graph_from_edges
from mma_tpu_torch.convert import node_classifier_from_jax, node_classifier_to_numpy
from mma_tpu_torch.ops import get_agg_spec, masked_multi_aggregate
from mma_tpu_torch.ops.cuda import fused_mma
from mma_tpu_torch.ops.masked_aggregate import (
    _edge_messages,
    _flat_lanes,
    sigmoid_lane_pattern,
)
from mma_tpu_torch.train import NODE_CLS_PRESETS, make_optimizer, train_node_classification
from mma_tpu_torch.train.loops import node_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("aggs", [("mean", "std"), ("moment_3", "sum")])
def test_half_fused_route_matches_xla(graphs, aggs):
    """The moment combines take the half-fused route: forward and gradients
    against the JAX package's XLA path under ``parity=False`` (f32, another
    summation order: 1e-4)."""
    jg, tg, n = graphs
    f, k = 12, len(aggs)
    rs = np.random.RandomState(1)
    h = rs.randn(jg.n_node, f).astype(np.float32)
    mw = (rs.randn(k, 2 * f, f) / np.sqrt(f)).astype(np.float32)
    g = rs.randn(jg.n_node, k, f).astype(np.float32)
    g[n:] = 0.0
    jspecs = [jax_get_agg_spec(a) for a in aggs]

    def jfwd(h_, mw_):
        return jax_masked_multi_aggregate(h_, jg, mw_, jspecs, parity=False, use_pallas=False)

    want = np.asarray(jfwd(jnp.asarray(h), jnp.asarray(mw)))
    jdh, jdmw = (np.asarray(x) for x in jax.grad(
        lambda h_, mw_: jnp.sum(jfwd(h_, mw_) * g), argnums=(0, 1))(jnp.asarray(h),
                                                                     jnp.asarray(mw)))
    th = torch.tensor(h, requires_grad=True)
    tmw = torch.tensor(mw, requires_grad=True)
    out = masked_multi_aggregate(th, tg, tmw, [get_agg_spec(a) for a in aggs], parity=False)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy()[:n], want[:n], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(th.grad.numpy()[:n], jdh[:n], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tmw.grad.numpy(), jdmw, rtol=1e-4,
                               atol=1e-4 * np.abs(jdmw).max())


def _aggregate_inputs(tg, f=16, aggs=("mean", "max"), seed=2):
    rs = np.random.RandomState(seed)
    h = torch.from_numpy(rs.randn(tg.n_node, f).astype(np.float32))
    mw = torch.from_numpy((rs.randn(len(aggs), 2 * f, f) / np.sqrt(f)).astype(np.float32))
    return h, mw, [get_agg_spec(a) for a in aggs]


def test_mask_dropout_rate_zero_is_the_fused_route(graphs):
    """Rate 0 with a generator is the deterministic fused output, and the
    half-fused messages without dropout sum to the fused program's S."""
    _, tg, _ = graphs
    h, mw, specs = _aggregate_inputs(tg)
    plain = masked_multi_aggregate(h, tg, mw, specs)
    with_gen = masked_multi_aggregate(h, tg, mw, specs, mask_dropout_rate=0.0,
                                      generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(with_gen, plain, rtol=0, atol=0)

    f = h.shape[1]
    pat = sigmoid_lane_pattern(specs, "new_sigmoid", True, f, "cpu")
    msgs = _edge_messages(h, tg, mw, pat, 0.0, None)
    half = fused_mma.segment_sum_csr(msgs, tg.real_row_ptr)
    fused = fused_mma.edge_program_lean(h @ _flat_lanes(mw[:, :f]), _flat_lanes(mw[:, f:]),
                                        h, pat, tg.src, tg.real_row_ptr, tg.real_col_ptr,
                                        tg.dst_csc)
    torch.testing.assert_close(half, fused, rtol=1e-5, atol=1e-5)


def test_mask_dropout_is_seeded_and_keeps_one_minus_rate(graphs):
    _, tg, n = graphs
    h, mw, specs = _aggregate_inputs(tg)

    def run(seed, rate=0.5):
        return masked_multi_aggregate(h, tg, mw, specs, mask_dropout_rate=rate,
                                      generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.equal(run(3)[:n], run(4)[:n])
    assert not torch.equal(run(3)[:n], masked_multi_aggregate(h, tg, mw, specs)[:n])

    # Constant logits: every kept mask entry is σ(0) / (1 - rate), every
    # dropped one 0, so the kept share is the share of non-zero entries.
    f = h.shape[1]
    pat = sigmoid_lane_pattern(specs, "new_sigmoid", False, f, "cpu")
    hi = int(tg.real_row_ptr[-1])
    for rate in (0.25, 0.75):
        msgs = _edge_messages(torch.ones_like(h), tg, torch.zeros_like(mw), pat, rate,
                              torch.Generator().manual_seed(5))[:hi]
        kept = msgs != 0
        assert abs(kept.float().mean().item() - (1 - rate)) < 0.01  # ≈ 51k draws
        torch.testing.assert_close(msgs[kept], torch.full_like(msgs[kept], 0.5 / (1 - rate)))


def test_adam_steps_match_jax(graphs):
    """3 Adam steps of the node classifier (dropout 0) from the same
    parameters, against ``make_optimizer`` + ``jax.value_and_grad``.

    Rule (Adam divides by √v, so an element whose gradient is rounding
    noise can move by ±lr in either package): step-1 gradients within 1e-4
    of each tensor's scale; the loss of every step within 1e-5 relative;
    parameters after 3 steps within 1e-5 where the step-1 gradient exceeds
    1e-3 of its tensor's max, and within 2·lr·steps elsewhere."""
    jg, tg, n = graphs
    rs = np.random.RandomState(3)
    x = rs.randn(jg.n_node, 24).astype(np.float32)
    labels = rs.randint(0, 5, jg.n_node).astype(np.int32)
    idx = rs.permutation(n)[:120].astype(np.int32)
    lr, wd, steps = 0.01, 5e-4, 3

    jmodel = JaxNodeClassifier(n_feat=24, n_hidden=16, n_class=5, aggregators=("mean", "mean2"),
                               dropout_rate=0.0)
    params = jmodel.init(jax.random.PRNGKey(4))
    opt = jax_make_optimizer(lr, wd)
    opt_state = opt.init(params)
    jx, jlab, jidx = jnp.asarray(x), jnp.asarray(labels), jnp.asarray(idx)

    def loss_fn(p):
        logp = jmodel.apply(p, jx, jg, training=True, rng=jax.random.PRNGKey(0))
        return -jnp.mean(logp[jidx, jlab[jidx]])

    model = NodeClassifier(24, 16, 5, ("mean", "mean2"), dropout_rate=0.0, device="cpu")
    node_classifier_from_jax(_np_tree(params), model)
    topt = make_optimizer(model.parameters(), lr, wd)
    tx, tlab, tidx = (torch.from_numpy(a) for a in (x, labels.astype(np.int64),
                                                     idx.astype(np.int64)))

    jgrads1 = tgrads1 = None
    for step in range(steps):
        jloss, jgrads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(jgrads, opt_state, params)
        params = optax.apply_updates(params, updates)
        tloss, _ = node_train_step(model, topt, tx, tg, tlab, tidx, torch.Generator())
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        if step == 0:
            jgrads1 = _np_tree(jgrads)
            tgrads1 = {name: {p: t.grad.numpy().copy()
                              for p, t in getattr(model, name).named_parameters()}
                       for name in ("gc1", "mma")}
    for layer in jgrads1:
        for p, want in jgrads1[layer].items():
            np.testing.assert_allclose(tgrads1[layer][p], want, rtol=0,
                                       atol=1e-4 * np.abs(want).max(), err_msg=f"{layer}.{p}")
    got_params = node_classifier_to_numpy(model)
    for layer, tree in _np_tree(params).items():
        for p, want in tree.items():
            g1 = np.abs(jgrads1[layer][p])
            sure = g1 > 1e-3 * g1.max()
            diff = np.abs(got_params[layer][p] - want)
            assert diff[sure].max(initial=0.0) <= 1e-5, f"{layer}.{p}"
            assert diff.max() <= 2 * lr * steps, f"{layer}.{p}"


def test_train_node_classification_records_match_jax():
    """The Cora preset for 3 epochs on the CPU: the same record and result
    keys as the JAX package's loop (run for 1 epoch), finite values."""
    cfg = dataclasses.replace(NODE_CLS_PRESETS["cora"], epochs=3)
    res = train_node_classification(cfg, device="cpu")
    jres = jax_train_node_classification(dataclasses.replace(cfg, epochs=1))
    assert set(jres) <= set(res)
    assert [set(r) for r in res["history"]] == [set(jres["history"][0])] * 3
    assert [r["epoch"] for r in res["history"]] == [1, 2, 3]
    values = [v for r in res["history"] for v in r.values()] + [res["loss_test"], res["acc_test"]]
    assert np.isfinite(values).all()
    assert 0.0 <= res["acc_test"] <= 1.0
    assert jax.tree.structure(jax.tree.map(np.shape, _np_tree(jres["params"]))) == \
        jax.tree.structure(jax.tree.map(np.shape, res["params"]))


def test_train_node_cli_runs_on_the_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "mma_tpu_torch.cli.train_node", "--device", "cpu",
         "--epochs", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1].startswith("Test set results: loss= ")


def test_parity_eval_dropout_is_mask_dropout_in_eval(graphs):
    """N2: with ``parity_eval_dropout`` and a generator the eval forward
    drops mask entries (seeded); without either it is deterministic."""
    _, tg, n = graphs
    x = torch.from_numpy(np.random.RandomState(8).randn(tg.n_node, 24).astype(np.float32))
    model = NodeClassifier(24, 16, 5, ("mean", "mean2"), dropout_rate=0.5, device="cpu",
                           generator=torch.Generator().manual_seed(0))

    def run(seed=None, parity=True):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return model(x, tg, generator=gen, parity_eval_dropout=parity)[:n]

    plain = run()
    torch.testing.assert_close(run(1, parity=False), plain, rtol=0, atol=0)
    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert not torch.equal(run(1), plain)


@pytest.mark.parametrize("metric", ["accuracy", "mae", "accuracy_sbm", "binary_f1_score",
                                    "weighted_f1_score"])
def test_metrics_match_jax(metric):
    from mma_tpu.train import metrics as jax_metrics
    from mma_tpu_torch.train import metrics

    rs = np.random.RandomState(9)
    if metric == "mae":
        a, b = rs.randn(50).astype(np.float32), rs.randn(50).astype(np.float32)
    else:
        a = rs.randn(60, 3).astype(np.float32)
        b = rs.randint(0, 2 if metric == "binary_f1_score" else 3, 60)
    want = float(getattr(jax_metrics, metric)(jnp.asarray(a), jnp.asarray(b)))
    got = float(getattr(metrics, metric)(torch.from_numpy(a), torch.from_numpy(b)))
    assert got == pytest.approx(want, rel=1e-6)


def test_reduce_lr_on_plateau_matches_jax():
    from mma_tpu.train.optim import ReduceLROnPlateau as JaxPlateau
    from mma_tpu_torch.train import ReduceLROnPlateau

    metrics = list(np.random.RandomState(10).rand(40)) + [0.5] * 60
    ours, theirs = ReduceLROnPlateau(1e-3, patience=5), JaxPlateau(1e-3, patience=5)
    lrs = [(ours.step(m), theirs.step(m)) for m in metrics]
    assert [a for a, _ in lrs] == [b for _, b in lrs]
    assert lrs[-1][0] < 1e-3  # it did reduce
