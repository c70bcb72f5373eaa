"""The port's MultiMaskConv and ZincNet against the JAX package and the
reference oracle, on the CPU (the kernels' plain versions).

Inputs, parameters and, for the fused route, the dropout seeds are made
once and handed to both packages. Tolerances:

- against the JAX XLA path and the Pallas CSR route: outputs within 1e-5
  and gradients within 1e-5 of each tensor's largest value (f32 products
  and sums taken in another order; min/max select the same edges). In
  ZincNet each conv's ``lin.b`` and its post-NNs' last biases only shift
  the input of a training BatchNorm by a constant per channel, which the
  BatchNorm subtracts again: their gradients are 0 in exact arithmetic and
  rounding noise in both packages, so there both sides must lie within
  1e-5 of the largest gradient of the same conv's ``lin.w``;
- against ``tests/oracle.py`` (numpy, the reference's loop order): 3e-4,
  as ``tests/test_graph_regression.py`` holds the JAX package;
- 3 Adam steps: the rule of ``tests/test_torch_training.py``.
"""

import copy
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mma_tpu.data import load_zinc as jax_load_zinc
from mma_tpu.models import ZincNet as JaxZincNet
from mma_tpu.nn.mma_conv import MultiMaskConv as JaxMultiMaskConv
from mma_tpu.train.optim import make_optimizer as jax_make_optimizer

from helpers import random_symmetric_graph
from oracle import oracle_zinc_conv

from mma_tpu_torch.convert import (
    multi_mask_conv_from_jax,
    multi_mask_conv_to_numpy,
    zinc_net_from_jax,
    zinc_net_to_numpy,
)
from mma_tpu_torch.data import load_zinc
from mma_tpu_torch.graph import graph_from_edges
from mma_tpu_torch.models import ZincNet
from mma_tpu_torch.nn.mma_conv import MultiMaskConv
from mma_tpu_torch.ops.cuda import segment_minmax as mm
from mma_tpu_torch.train import ZincConfig, make_optimizer
from mma_tpu_torch.train.loops import l1_loss, zinc_layout, zinc_train_step

N, F, EDGE_DIM, TOWERS = 24, 8, 6, 2
AVG_DEG = {"lin": 2.1, "log": 1.05, "exp": 9.3}
AGG_SETS = [
    (("min", "max"), ("identity", "amplification", "linear")),  # README.md:79
    (("mean", "max", "min"), ("identity", "amplification", "attenuation")),  # the CLI default
    (("sum", "mean"), ("identity", "inverse_linear")),
]
# The PNA aggregator set PyG's examples/pna.py trains ZINC with.
PNA_SET = (("mean", "min", "max", "std"), ("identity", "amplification", "attenuation"))
SMALL_NET = dict(num_layers=2, hidden=10, edge_hidden=6, towers=2, mlp_sizes=(10, 6, 1))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def graphs():
    _, _, jg = random_symmetric_graph(N, p=0.15, seed=3)
    mask = np.asarray(jg.edge_mask)
    tg = graph_from_edges(np.asarray(jg.src)[mask], np.asarray(jg.dst)[mask], N,
                          n_node_pad=jg.n_node, n_edge_pad=jg.n_edge, device="cpu")
    rs = np.random.RandomState(5)
    x = rs.randn(jg.n_node, F).astype(np.float32)
    x[N:] = 0.0
    e = rs.randn(jg.n_edge, EDGE_DIM).astype(np.float32)
    ct = rs.randn(jg.n_node, F).astype(np.float32)
    ct[N:] = 0.0
    return jg, tg, x, e, ct


def _grad_tree(module, to_numpy):
    """The module's gradients in the JAX tree layout (zeros where the loss
    does not reach a parameter, as ``jax.grad`` gives)."""
    shadow = copy.deepcopy(module)
    with torch.no_grad():
        for p, q in zip(shadow.parameters(), module.parameters()):
            p.copy_(q.grad if q.grad is not None else torch.zeros_like(q))
    return to_numpy(shadow)


def _assert_trees_close(got, want, what, rel=1e-5, slack=None):
    """Leaf by leaf within ``rel`` of the leaf's largest value, plus the
    leaf's entry of the ``slack`` tree where one is given."""
    slacks = jax.tree.leaves(slack) if slack is not None else [0.0] * len(jax.tree.leaves(got))
    for (path, w), g, extra in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                   jax.tree.leaves(got), slacks):
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * np.abs(w).max() + extra,
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


def _pop_bn_fed_biases(conv_tree):
    """Remove and return a ZincNet conv's biases that feed a BatchNorm as a
    per-channel constant: ``lin.b`` and each post-NN's last ``b``."""
    return [conv_tree["lin"].pop("b")] + [tower[-1].pop("b") for tower in conv_tree["post_nns"]]


def _conv_pair(aggs, scalers, parity):
    jconv = JaxMultiMaskConv(in_channels=F, out_channels=F, aggregators=aggs, scalers=scalers,
                             avg_deg=tuple(AVG_DEG.items()), edge_dim=EDGE_DIM, towers=TOWERS,
                             parity=parity)
    params = jconv.init(jax.random.PRNGKey(0))
    conv = MultiMaskConv(F, F, aggs, scalers, AVG_DEG, edge_dim=EDGE_DIM, towers=TOWERS,
                         parity=parity, device="cpu")
    multi_mask_conv_from_jax(_np(params), conv)
    return jconv, params, conv


def _run_conv(conv, tg, x, e, ct, **kw):
    tx = torch.tensor(x, requires_grad=True)
    out = conv(tx, tg, torch.from_numpy(e), **kw)
    (out * torch.from_numpy(ct)).sum().backward()
    return out.detach().numpy(), tx.grad.numpy(), _grad_tree(conv, multi_mask_conv_to_numpy)


@pytest.mark.parametrize("parity", [True, False])
@pytest.mark.parametrize("aggs,scalers", AGG_SETS)
def test_conv_matches_jax_and_oracle(graphs, aggs, scalers, parity):
    """Forward and every gradient against the JAX XLA path; forward against
    the oracle. ``min,max`` takes the fused edge program (kernels 6-7),
    ``mean,max,min`` the general route (kernels 1, 4, 5), ``sum,mean``
    kernel 1 only."""
    jg, tg, x, e, ct = graphs
    jconv, params, conv = _conv_pair(aggs, scalers, parity)

    def jloss(p, x_):
        out = jconv.apply(p, x_, jg, edge_attr=jnp.asarray(e))
        return jnp.sum(out * ct), out

    (_, want), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    before = dict(mm.LAUNCHES)
    out, gx, gp = _run_conv(conv, tg, x, e, ct)
    assert mm.LAUNCHES == before  # plain versions on the CPU
    want = np.asarray(want)
    np.testing.assert_allclose(out[:N], want[:N], rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(gx[:N], np.asarray(jgx)[:N], rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jgx)).max())
    _assert_trees_close(gp, _np(jgp), "grad")
    if parity:  # N7: the pre-NNs are detached
        assert all(p.grad is None for p in conv.pre_nns.parameters())

    e_mask = np.asarray(jg.edge_mask)
    enc = _np(params["edge_encoder"])
    oracle_params = {
        "pre": [[(t[0]["w"], t[0]["b"]) for t in agg] for agg in _np(params["pre_nns"])],
        "post": [(t[0]["w"], t[0]["b"]) for t in _np(params["post_nns"])],
        "lin": (np.asarray(params["lin"]["w"]), np.asarray(params["lin"]["b"])),
    }
    oracle = oracle_zinc_conv(
        x[:N], np.asarray(jg.src)[e_mask], np.asarray(jg.dst)[e_mask],
        e[e_mask] @ enc["w"] + enc["b"], oracle_params, list(aggs), list(scalers), AVG_DEG,
        TOWERS, parity=parity)
    np.testing.assert_allclose(out[:N], oracle, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("parity", [True, False])
def test_fused_route_with_jax_seeds_matches_pallas_csr(graphs, parity):
    """Dropout on: the port's fused route fed the JAX package's own hash
    seeds (``randint(rng, (1,), 0, 2³¹-1)``, per aggregator in fixed mode)
    against ``use_pallas=True, edge_format="csr"`` in interpret mode."""
    jg, tg, x, e, ct = graphs
    aggs, scalers = AGG_SETS[0]
    jconv, params, conv = _conv_pair(aggs, scalers, parity)
    jconv = dataclasses.replace(jconv, edge_format="csr")
    rng = jax.random.PRNGKey(11)
    keys = [rng] if parity else list(jax.random.split(rng, len(aggs)))
    seeds = [int(jax.random.randint(k, (1,), 0, 2**31 - 1)[0]) for k in keys]

    def jloss(p, x_):
        out = jconv.apply(p, x_, jg, edge_attr=jnp.asarray(e), rng=rng, use_pallas=True)
        return jnp.sum(out * ct), out

    (_, want), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    out, gx, gp = _run_conv(conv, tg, x, e, ct, seed=seeds[0] if parity else seeds)
    want = np.asarray(want)
    np.testing.assert_allclose(out[:N], want[:N], rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(gx[:N], np.asarray(jgx)[:N], rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jgx)).max())
    _assert_trees_close(gp, _np(jgp), "grad")
    # Without the seeds the output differs: the dropout was on.
    no_drop = conv(torch.from_numpy(x), tg, torch.from_numpy(e)).detach().numpy()
    assert not np.allclose(no_drop[:N], out[:N])


@pytest.mark.parametrize("parity", [True, False])
@pytest.mark.parametrize("aggs,scalers", [(("var", "std"), ("identity", "linear")), PNA_SET])
def test_conv_var_std_matches_jax_and_oracle(graphs, aggs, scalers, parity):
    """var/std through kernel 8's plain version, against the JAX conv's
    Pallas CSR route (``fused_segment_sum_sq``, interpret mode) and its XLA
    path: the forward at rtol 1e-4 / atol 1e-5 (the JAX package's own
    tolerance for the pair, ``tests/test_graph_regression.py:286-289``) and
    against the oracle at 3e-4.

    Every gradient at rtol 1e-4 and an atol of 1e-5 plus four times the
    port's own change when the input ``x`` moves by one ulp: ``var =
    E[x²] − E[x]²`` cancels where a row's messages nearly agree, and std's
    ``1 / (2·sqrt(var + 1e-5))`` multiplies that rounding by up to 158, so
    the two packages' f32 messages (equal to a few ulps) give gradients
    that differ by as much as rounding alone moves them. Without ``std``
    in the set that allowance is below 1e-6 of each tensor."""
    jg, tg, x, e, ct = graphs
    jconv, params, conv = _conv_pair(aggs, scalers, parity)
    out, gx, gp = _run_conv(conv, tg, x, e, ct)
    conv.zero_grad(set_to_none=True)
    nudged = np.where(np.arange(x.shape[0])[:, None] < N, np.nextafter(x, np.inf), 0.0)
    _, gx1, gp1 = _run_conv(conv, tg, nudged.astype(np.float32), e, ct)
    for use_pallas in (True, False):
        jc = dataclasses.replace(jconv, edge_format="csr") if use_pallas else jconv

        def jloss(p, x_):
            o = jc.apply(p, x_, jg, edge_attr=jnp.asarray(e), use_pallas=use_pallas)
            return jnp.sum(o * ct), o

        (_, want), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
            params, jnp.asarray(x))
        np.testing.assert_allclose(out[:N], np.asarray(want)[:N], rtol=1e-4, atol=1e-5)
        pairs = [("x", gx[:N], gx1[:N], np.asarray(jgx)[:N])] + [
            (jax.tree_util.keystr(path), g, g1, w) for (path, w), g, g1 in zip(
                jax.tree_util.tree_flatten_with_path(_np(jgp))[0], jax.tree.leaves(gp),
                jax.tree.leaves(gp1))]
        for name, g, g1, w in pairs:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 + 4 * np.abs(g - g1).max(),
                                       err_msg=f"use_pallas={use_pallas} grad {name}")

    e_mask = np.asarray(jg.edge_mask)
    enc = _np(params["edge_encoder"])
    oracle_params = {
        "pre": [[(t[0]["w"], t[0]["b"]) for t in agg] for agg in _np(params["pre_nns"])],
        "post": [(t[0]["w"], t[0]["b"]) for t in _np(params["post_nns"])],
        "lin": (np.asarray(params["lin"]["w"]), np.asarray(params["lin"]["b"])),
    }
    oracle = oracle_zinc_conv(
        x[:N], np.asarray(jg.src)[e_mask], np.asarray(jg.dst)[e_mask],
        e[e_mask] @ enc["w"] + enc["b"], oracle_params, list(aggs), list(scalers), AVG_DEG,
        TOWERS, parity=parity)
    np.testing.assert_allclose(out[:N], oracle, rtol=3e-4, atol=3e-4)


def _net_pair(aggs, scalers, parity, key=0):
    ds = jax_load_zinc("val", subset_size=24)
    avg = dict(AVG_DEG)
    jnet = JaxZincNet(aggregators=aggs, scalers=scalers, avg_deg=tuple(avg.items()),
                      parity=parity, **SMALL_NET)
    params, state = jnet.init(jax.random.PRNGKey(key)), jnet.init_state()
    net = ZincNet(aggs, scalers, avg, parity=parity, device="cpu", **SMALL_NET)
    zinc_net_from_jax(_np(params), _np(state), net)
    kw = dict(n_node=24 * 40, n_edge=24 * 100)
    jb = next(ds.batches(16, **kw))
    tb = next(load_zinc("val", subset_size=24).batches(16, device="cpu", **kw))
    return jnet, params, state, net, jb, tb


@pytest.mark.parametrize("aggs,scalers,parity", [AGG_SETS[0] + (True,), AGG_SETS[1] + (False,)])
def test_zinc_net_forward_and_grads_match_jax(aggs, scalers, parity):
    """A training forward (batch statistics, dropout off) of the whole
    model: predictions, the BatchNorm state it leaves and every gradient
    of the L1 loss."""
    _zinc_net_matches_jax(aggs, scalers, parity)


def test_zinc_net_pna_forward_and_grads_match_jax():
    """The same for the PNA set, each gradient with the allowance of
    :func:`test_conv_var_std_matches_jax_and_oracle`: four times the port's
    own change when its node embedding table (every layer's input) moves by
    one ulp. At layer 0 all atoms of a type share one embedding, so a row
    whose neighbours are alike has ``var`` near 0, where std amplifies
    rounding."""
    _zinc_net_matches_jax(*PNA_SET, parity=True, nudge=True)


def _zinc_net_matches_jax(aggs, scalers, parity, nudge=False):
    jnet, params, state, net, jb, tb = _net_pair(aggs, scalers, parity)

    def jloss(p):
        pred, new_state = jnet.apply(p, state, jb, training=True)
        gm = jb.graph_mask.astype(pred.dtype)
        return jnp.sum(jnp.abs(pred - jb.target) * gm) / jnp.sum(gm), (pred, new_state)

    def port_grads(model):
        pred = model(tb, training=True)
        loss = l1_loss(pred, tb)
        loss.backward()
        return pred, loss, _grad_tree(model, lambda m: zinc_net_to_numpy(m)[0])

    slack = None
    if nudge:
        nudged = copy.deepcopy(net)
        with torch.no_grad():
            table = nudged.node_emb.table
            table.copy_(torch.nextafter(table, torch.tensor(np.inf)))
        _, _, g1 = port_grads(nudged)
    (jl, (jpred, jstate)), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    pred, loss, got_g = port_grads(net)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(jpred), rtol=1e-5, atol=1e-5)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    want_g = _np(jgrads)
    if nudge:
        slack = jax.tree.map(lambda a, b: 4 * np.abs(a - b).max(), got_g, g1)
    for i in range(SMALL_NET["num_layers"]):
        scale = np.abs(want_g[f"conv{i}"]["lin"]["w"]).max()
        allow = 0.0 if slack is None else max(_pop_bn_fed_biases(slack[f"conv{i}"]))
        for tree in (got_g, want_g):
            for b in _pop_bn_fed_biases(tree[f"conv{i}"]):
                assert np.abs(b).max() <= 1e-5 * scale + allow
    _assert_trees_close(got_g, want_g, "grad", slack=slack)
    _, got_state = zinc_net_to_numpy(net)
    _assert_trees_close(got_state, _np(jstate), "state", rel=1e-6)
    # Eval mode uses the running statistics.
    with torch.no_grad():
        ev = net(tb, training=False).numpy()
    jev, _ = jnet.apply(params, jstate, jb, training=False)
    np.testing.assert_allclose(ev, np.asarray(jev), rtol=1e-5, atol=1e-5)


def test_adam_steps_match_jax():
    _adam_steps_match_jax(*AGG_SETS[0])


def test_adam_steps_match_jax_pna():
    """The rule of :func:`_adam_steps_match_jax` for the PNA set (kernels 1,
    4, 5 and 8 on the card)."""
    _adam_steps_match_jax(*PNA_SET)


def _adam_steps_match_jax(aggs, scalers):
    """3 Adam steps (lr 1e-3, weight decay 3e-4, dropout off) of the README
    preset's aggregators under parity: every parameter, the detached
    pre-NNs included (their update comes from weight decay alone, as in
    the JAX package), and the BatchNorm state.

    Rule: the loss of every step within 1e-5 relative; parameters after 3
    steps within 1e-5 where the step-1 gradient exceeds 1e-3 of its
    tensor's max and within 2·lr·steps elsewhere (Adam divides by √v, so a
    rounding-noise gradient, such as the BatchNorm-fed biases have, can
    move an element by ±lr); the pre-NNs within 1e-6, and moved from their
    initial values by about lr a step (the median); the BatchNorm state
    within 1e-4 of its largest value (the running means average conv
    outputs that carry those biases)."""
    jnet, params, state, net, jb, tb = _net_pair(aggs, scalers, True, key=3)
    lr, wd, steps = 1e-3, 3e-4, 3
    opt = jax_make_optimizer(lr, wd)
    opt_state = opt.init(params)
    init = _np(params)
    topt = make_optimizer(net.parameters(), lr, wd)

    def jloss(p, s):
        pred, new_state = jnet.apply(p, s, jb, training=True)
        gm = jb.graph_mask.astype(pred.dtype)
        return jnp.sum(jnp.abs(pred - jb.target) * gm) / jnp.sum(gm), new_state

    grads1 = None
    for step in range(steps):
        (jl, state), jg = jax.value_and_grad(jloss, has_aux=True)(params, state)
        updates, opt_state = opt.update(jg, opt_state, params)
        params = optax.apply_updates(params, updates)
        tl = zinc_train_step(net, topt, tb, None)
        assert float(tl) == pytest.approx(float(jl), rel=1e-5), step
        if step == 0:
            grads1 = _np(jg)
    got, got_state = zinc_net_to_numpy(net)
    want = _np(params)
    leaves = zip(jax.tree_util.tree_flatten_with_path(want)[0], jax.tree.leaves(got),
                 jax.tree.leaves(grads1), jax.tree.leaves(init))
    for (path, w), g, g1, p0 in leaves:
        name = jax.tree_util.keystr(path)
        diff = np.abs(g - w)
        if "pre_nns" in name:
            assert not np.abs(g1).any(), name
            assert diff.max() <= 1e-6, name
            assert np.median(np.abs(g - p0)) > 0.5 * lr * steps, name
            continue
        sure = np.abs(g1) > 1e-3 * np.abs(g1).max()
        if name.endswith("['b']") and ("['lin']" in name or "post_nns" in name):
            sure[:] = False  # a BatchNorm-fed bias: rounding-noise gradient (module docstring)
        assert diff[sure].max(initial=0.0) <= 1e-5, name
        assert diff.max() <= 2 * lr * steps, name
    _assert_trees_close(got_state, _np(state), "state", rel=1e-4)


def test_unported_requests_raise(graphs):
    jg, tg, x, e, _ = graphs
    kw = dict(edge_dim=EDGE_DIM, towers=TOWERS, device="cpu")
    for aggs in (("mean", "var"), ("std",)):  # ported: they build and run
        out = MultiMaskConv(F, F, aggs, ("identity",), AVG_DEG, **kw)(
            torch.from_numpy(x), tg, torch.from_numpy(e))
        assert out.shape == (tg.n_node, F) and torch.isfinite(out).all()
    # edge_format="ell" (ported): the single-width slot layout of
    # max_degree_hint gives the CSR route's output; without the hint the
    # conv keeps the CSR route.
    conv = MultiMaskConv(F, F, ("min", "max"), ("identity",), AVG_DEG, **kw)
    for hint in (int(tg.deg.max()), None):
        ell_conv = MultiMaskConv(F, F, ("min", "max"), ("identity",), AVG_DEG, edge_format="ell",
                                 max_degree_hint=hint, **kw)
        ell_conv.load_state_dict(conv.state_dict())
        torch.testing.assert_close(ell_conv(torch.from_numpy(x), tg, torch.from_numpy(e))[:N],
                                   conv(torch.from_numpy(x), tg, torch.from_numpy(e))[:N],
                                   rtol=1e-6, atol=1e-6)
    # compute_dtype="bfloat16" (ported): a bf16 conv builds and gives a
    # finite float32 output.
    bf16 = MultiMaskConv(F, F, ("min",), ("identity",), AVG_DEG, compute_dtype="bfloat16", **kw)
    out = bf16(torch.from_numpy(x), tg, torch.from_numpy(e))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    # axis_name (ported): on an edge axis of one rank (a gloo world of this
    # process alone) the general route with its cross-shard combine gives
    # the unsharded (fused-route) output.
    from torch_world import world_of_one

    with world_of_one() as mesh:
        sharded = conv(torch.from_numpy(x), tg, torch.from_numpy(e),
                       axis_name=mesh.get_group("edge"))
    torch.testing.assert_close(sharded[:N], conv(torch.from_numpy(x), tg, torch.from_numpy(e))[:N],
                               rtol=1e-6, atol=1e-6)
    # Degree-exact graphs and degree-ordered batches, and remat (ported):
    # the same molecules collated both ways give the same predictions, and
    # a remat training step runs on the exact batch.
    ds = load_zinc("val", subset_size=4)
    cfg = ZincConfig(batch_size=4, batch_layout="degree_exact")
    n_node, n_edge, budgets = zinc_layout(cfg, [ds])
    plain = next(ds.batches(4, n_node=n_node, n_edge=n_edge, device="cpu"))
    exact = next(ds.batches(4, n_node=n_node, n_edge=n_edge, device="cpu",
                            ell_degree_budgets=budgets))
    assert exact.graph.ell_exact and not exact.nodes_grouped
    net = ZincNet(("min", "max"), ("identity",), AVG_DEG, remat=True, device="cpu", **SMALL_NET)
    with torch.no_grad():
        torch.testing.assert_close(net(exact), net(plain), rtol=1e-5, atol=1e-5)
    loss = l1_loss(net(exact, training=True), exact)
    loss.backward()
    assert torch.isfinite(loss) and all(torch.isfinite(p.grad).all()
                                        for p in net.parameters() if p.grad is not None)
