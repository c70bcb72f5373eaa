"""Training with the bf16 edge pipeline, on the CPU: Adam steps of the node
classifier against the JAX package's Pallas path, the ELL route of the
sampled batches against the JAX ELL route, ``train_sampled`` and the
sampled command line in bf16 on the lean, half-fused and ELL routes.

Tolerances are at bf16 level (``tests/test_torch_bf16.py``): both
frameworks round at the same points, but a bf16 rounding of a value that
float32 sums of another order put on the other side of a rounding step
moves it by an ulp of bf16. Each test states what it measured.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mma_tpu.data.sampling import NeighborSampler as JaxNeighborSampler
from mma_tpu.graph.build import graph_from_edges as jax_graph_from_edges
from mma_tpu.models import NodeClassifier as JaxNodeClassifier
from mma_tpu.nn.mma_layer import MMALayer as JaxMMALayer
from mma_tpu.train.optim import make_optimizer as jax_make_optimizer

from mma_tpu_torch import MMALayer, NodeClassifier, graph_from_edges
from mma_tpu_torch.cli import train_sampled as cli
from mma_tpu_torch.convert import node_classifier_from_jax, node_classifier_to_numpy
from mma_tpu_torch.data.sampling import NeighborSampler
from mma_tpu_torch.train import make_optimizer, sampled as sampled_mod
from mma_tpu_torch.train.loops import node_train_step
from mma_tpu_torch.train.sampled import SampledTrainConfig, train_sampled

TOL = 1e-2


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


def test_bf16_adam_steps_match_jax():
    """3 Adam steps of ``NodeClassifier(compute_dtype="bfloat16")`` (dropout
    0: the lean route, kernels 1-3) through ``node_train_step``, against
    ``make_optimizer`` and ``jax.value_and_grad`` of the JAX model's
    ``use_pallas=True`` path from the same parameters. Rule, as
    ``tests/test_torch_training.py::test_adam_steps_match_jax`` at bf16
    level: every step's loss within 1e-2 relative; step-1 gradients within
    1e-2 of each tensor's scale; parameters within 1e-2·lr where the step-1
    gradient exceeds 1e-3 of its tensor's max, within 2·lr·steps elsewhere.
    Measured: losses within 1.9e-6 relative, gradients within 1.1e-3 of
    their scale, parameters within 4.6e-3·lr where sure."""
    rs = np.random.RandomState(0)
    n = 200
    src = rs.randint(0, n - 10, 1500).astype(np.int32)
    dst = rs.randint(0, n - 20, 1500).astype(np.int32)
    jg, tg = jax_graph_from_edges(src, dst, n), graph_from_edges(src, dst, n, device="cpu")
    rs = np.random.RandomState(3)
    x = rs.randn(jg.n_node, 24).astype(np.float32)
    labels = rs.randint(0, 5, jg.n_node).astype(np.int32)
    idx = rs.permutation(n)[:120].astype(np.int32)
    lr, wd, steps = 0.01, 5e-4, 3

    jmodel = JaxNodeClassifier(n_feat=24, n_hidden=16, n_class=5, aggregators=("mean", "mean2"),
                               dropout_rate=0.0, compute_dtype="bfloat16")
    params = jmodel.init(jax.random.PRNGKey(4))
    opt = jax_make_optimizer(lr, wd)
    opt_state = opt.init(params)
    jx, jlab, jidx = jnp.asarray(x), jnp.asarray(labels), jnp.asarray(idx)

    def loss_fn(p):
        logp = jmodel.apply(p, jx, jg, training=True, rng=jax.random.PRNGKey(0), use_pallas=True)
        return -jnp.mean(logp[jidx, jlab[jidx]])

    model = NodeClassifier(24, 16, 5, ("mean", "mean2"), dropout_rate=0.0,
                           compute_dtype="bfloat16", device="cpu")
    node_classifier_from_jax(jax.tree.map(np.asarray, params), model)
    topt = make_optimizer(model.parameters(), lr, wd)
    tx, tlab, tidx = (torch.from_numpy(a) for a in (x, labels.astype(np.int64),
                                                     idx.astype(np.int64)))
    jgrads1 = tgrads1 = None
    for step in range(steps):
        jloss, jgrads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(jgrads, opt_state, params)
        params = optax.apply_updates(params, updates)
        tloss, _ = node_train_step(model, topt, tx, tg, tlab, tidx, torch.Generator())
        assert abs(float(tloss) - float(jloss)) <= TOL * abs(float(jloss)), step
        if step == 0:
            jgrads1 = jax.tree.map(np.asarray, jgrads)
            tgrads1 = {name: {p: t.grad.numpy().copy()
                              for p, t in getattr(model, name).named_parameters()}
                       for name in ("gc1", "mma")}
    for layer in jgrads1:
        for p, want in jgrads1[layer].items():
            assert _rel_err(tgrads1[layer][p], want) < TOL, f"{layer}.{p}"
    got_params = node_classifier_to_numpy(model)
    for layer, tree in jax.tree.map(np.asarray, params).items():
        for p, want in tree.items():
            g1 = np.abs(jgrads1[layer][p])
            sure = g1 > 1e-3 * g1.max()
            diff = np.abs(got_params[layer][p] - want)
            assert diff[sure].max(initial=0.0) <= TOL * lr, f"{layer}.{p}"
            assert diff.max() <= 2 * lr * steps, f"{layer}.{p}"


# ------------------------------------------------------------- the ELL route

FANOUTS = (4, 4, 3)
HOP_PADS = (32, 160, 768, 2048)
PADS = dict(n_node_pad=4096, n_edge_pad=4096)


@pytest.fixture(scope="module")
def hopped():
    """``tests/test_torch_sampling.py``'s hopped batch, from both packages."""
    rs = np.random.RandomState(0)
    n = 3000
    a, b = rs.randint(0, n, 24000).astype(np.int32), rs.randint(0, n, 24000).astype(np.int32)
    keep = a != b
    src, dst = np.concatenate([a[keep], b[keep]]), np.concatenate([b[keep], a[keep]])
    seeds = rs.choice(n, 32, replace=False)
    tb = NeighborSampler.from_host_arrays(src, dst, n, FANOUTS, seed=1, device="cpu").sample(
        seeds, hop_node_pads=HOP_PADS, **PADS)
    jb = JaxNeighborSampler.from_host_arrays(src, dst, n, FANOUTS, seed=1).sample(
        seeds, hop_node_pads=HOP_PADS, **PADS)
    np.testing.assert_array_equal(np.asarray(jb.graph.src), tb.graph.src.numpy())
    feats = np.random.RandomState(2).randn(n, 10).astype(np.float32)
    x = np.zeros((tb.graph.n_node, 10), np.float32)
    valid = tb.node_ids >= 0
    x[valid] = feats[tb.node_ids[valid]]
    return tb, jb, x


@pytest.mark.parametrize("aggs,parity", [(("mean", "mean2"), True),
                                         (("std", "normalized_mean", "moment_3"), False)])
def test_bf16_mma_layer_ell_route_matches_jax(hopped, aggs, parity):
    """``MMALayer`` in bf16 on a hopped batch (the ELL route: a bf16 ``[d ‖
    h]`` slot table, float32 slot messages, the gather's VJP on kernel 1's
    bf16 form) against the JAX ELL route, output and every gradient within
    1e-2 of each tensor's scale. Measured: at most 3.9e-4."""
    tb, jb, x = hopped
    layer = JaxMMALayer(10, 10, aggs, parity=parity, compute_dtype="bfloat16")
    params = layer.init(jax.random.PRNGKey(1))
    mask = np.array(jb.graph.node_mask)[:, None]

    def jloss(p, xx):
        out = layer.apply(p, xx, jb.graph, use_pallas=True)
        return jnp.sum(jnp.where(mask, out, 0.0) ** 2), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    tl = MMALayer(10, 10, aggs, parity=parity, compute_dtype="bfloat16", device="cpu")
    with torch.no_grad():
        for name in ("w", "masks", "b"):
            getattr(tl, name).copy_(torch.from_numpy(np.array(params[name])))
    tx = torch.from_numpy(x).requires_grad_()
    out = tl(tx, tb.graph)
    torch.where(torch.from_numpy(mask), out, 0.0).pow(2).sum().backward()
    assert _rel_err(out.detach().numpy() * mask, np.asarray(jout) * mask) < TOL
    assert _rel_err(tx.grad, jgx) < TOL
    for name in ("w", "masks", "b"):
        assert _rel_err(tl.get_parameter(name).grad, jgp[name]) < TOL, name


# ------------------------------------------------------------ sampled runs

def test_bf16_train_sampled_steps():
    """Three ``train_sampled`` Adam steps of the bf16 model (dropout 0: the
    lean route; one 32-seed batch an epoch) from the float32 run's initial
    weights: finite, and every step's loss within 1e-2 of the float32
    run's. Measured: 5.4e-4 relative."""
    rs = np.random.RandomState(4)
    n = 300
    src, dst = rs.randint(0, n, 2400).astype(np.int32), rs.randint(0, n, 2400).astype(np.int32)
    keep = src != dst
    src, dst = np.concatenate([src[keep], dst[keep]]), np.concatenate([dst[keep], src[keep]])
    feats = rs.randn(n, 8).astype(np.float32)
    labels = rs.randint(0, 3, n)
    cfg = SampledTrainConfig(aggregators=("mean", "mean2"), hidden=12, lr=0.01, dropout=0.0,
                             epochs=3, batch_size=32, fanouts=(4, 4, 4), n_node_pad=1024,
                             n_edge_pad=4096, seed=0)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        model_cls = functools.partial(NodeClassifier, compute_dtype=dtype)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sampled_mod, "NodeClassifier", model_cls)
            runs[dtype] = train_sampled(cfg, graph_from_edges(src, dst, n, device="cpu"),
                                        feats, labels, np.arange(32), device="cpu")
    assert runs["bfloat16"]["model"].mma.edge_dtype == torch.bfloat16
    losses = {k: np.array([r["loss"] for r in v["history"]]) for k, v in runs.items()}
    assert np.isfinite(losses["bfloat16"]).all()
    np.testing.assert_allclose(losses["bfloat16"], losses["float32"], rtol=TOL)


TINY = ["--device", "cpu", "--nodes", "2000", "--avg-deg", "8", "--batch-size", "32",
        "--fanouts", "4,4,3", "--n-feat", "8", "--hidden", "8", "--n-class", "5",
        "--steps", "3"]


@pytest.mark.parametrize("flags", [["--dropout", "0"], [], ["--use-ell"]],
                         ids=["lean", "half_fused", "ell"])
def test_bf16_cli_runs_on_the_cpu(flags):
    """The sampled command line with ``--compute-dtype bfloat16`` on each
    route (dropout 0: kernels 1-3; the default dropout: bf16 messages and
    kernel 1; ``--use-ell``): 3 finite steps on the same batches as the
    float32 run, each loss within 1e-2 of its loss (measured: 3.9e-4 at
    most). The default ``auto`` is the float32 run, bit for bit."""
    bf = cli.main(TINY + flags + ["--compute-dtype", "bfloat16"])
    f32 = cli.main(TINY + flags + ["--compute-dtype", "float32"])
    auto = cli.main(TINY + flags)
    assert bf["model"].mma.edge_dtype == torch.bfloat16
    assert [r["edges"] for r in bf["records"]] == [r["edges"] for r in f32["records"]]
    assert np.isfinite(bf["losses"]).all()
    np.testing.assert_allclose(bf["losses"], f32["losses"], rtol=TOL)
    np.testing.assert_array_equal(auto["losses"], f32["losses"])
