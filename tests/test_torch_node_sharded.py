"""The port's node-sharded (halo) regime against the JAX package, on gloo
worlds of 2 and 4 CPU processes.

``mma_tpu_torch.parallel.node_sharded`` runs one process per rank, each
holding its row of the host plan; the JAX package runs the regime in this
process on a ``("node",)`` mesh of the first W of the 8 forced host
devices (``tests/conftest.py``), on its XLA path (``use_pallas=False``).
Inputs come from numpy seeds; parameters go through
``mma_tpu_torch.convert``. Each world runs once per module and size
(:func:`world`): every rank runs :func:`node_worker` over all the cases.
The ranks import this module, so it imports JAX and ``mma_tpu`` only
inside the functions that compute the JAX side.

Tolerances, from ``tests/test_parallel.py`` and ``tests/test_partition.py``:
plans, ``shard_node_values`` and the exchanged halo rows bit for bit; the
exchange's backward within 1e-6; forwards within rtol = atol = 2e-4 of
the JAX node-sharded forward and of the port's unsharded forward (the JAX
test's own ceiling, ``test_parallel.py:179-183``; both hold at 1e-5
here, which the tests also check); gradients rtol 3e-4, atol 1e-5; one
Adam step (dropout off): loss rtol 1e-5, parameters rtol 1e-4, atol 1e-5;
with dropout, the last of 30 losses under 0.9 of the first; the
LDG-ordered forward within atol 2e-4 of the unsharded one.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_world import (
    grads_numpy,
    graph_arrays,
    graph_from_arrays,
    numpy_tree,
    params_numpy,
    rank_inputs,
    run_world,
    world_of_one,
    write_rank_results,
)

pytestmark = pytest.mark.multichip

N, F_IN, HID, N_CLASS = 60, 12, 16, 4
AGGS = ("mean", "min2", "max")
ALL_AGGS = ("mean", "max", "std", "normalized_mean", "moment_3")
N_TRAIN_PICK, HALO_F = 30, 5
DROPOUT_STEPS = 30
LDG_N, LDG_F, LDG_CLASS = 96, 10, 3
WORLDS = (2, 4)
PLAN_SHARDS = (2, 4, 8)


def _plan_fields():
    from mma_tpu_torch.parallel import NodeShardedGraph

    return [f.name for f in dataclasses.fields(NodeShardedGraph)]


# ------------------------------------------------------------------ ranks

def node_worker(workdir):
    """One rank: every case of this module over the inputs in ``workdir``."""
    from mma_tpu_torch.convert import node_classifier_from_jax
    from mma_tpu_torch.models import NodeClassifier
    from mma_tpu_torch.parallel import (
        build_node_sharded,
        build_node_sharded_ordered,
        halo_exchange,
        initialize_distributed,
        make_mesh,
        make_node_sharded_forward,
        make_node_sharded_train_step,
        place_on_mesh,
        psum,
        psum_grads,
        shard_node_values,
    )
    from mma_tpu_torch.parallel import collectives
    from mma_tpu_torch.train import make_optimizer

    initialize_distributed("cpu")
    torch.use_deterministic_algorithms(True)
    inp = rank_inputs(workdir)
    mesh = make_mesh(("node",))
    group = mesh.get_group("node")
    size, rank = mesh.size(), mesh.get_local_rank("node")
    graph = graph_from_arrays(inp["graph"])
    sg, cuts = build_node_sharded(graph, size)
    n_m = sg.node_mask.shape[1]
    sgl = place_on_mesh(sg, mesh, "node")

    def local(values):
        return place_on_mesh(shard_node_values(values, cuts, n_m), mesh, "node")

    x = local(inp["x"][:N])
    res = {}

    # The exchange: rows, the reverse route of its cotangent, the counters.
    v = local(inp["halo_vals"]).requires_grad_()
    collectives.reset_stats()
    out = halo_exchange(v, sgl, group)
    res["stats_fwd"] = dict(collectives.STATS)
    ct = torch.from_numpy(inp["halo_ct"][rank])
    (out * ct).sum().backward()
    res["stats_bwd"] = dict(collectives.STATS)
    res["halo"], res["halo_grad"] = out.detach().numpy(), v.grad.numpy()
    res["halo_dot"] = float((out.detach() * ct).sum())

    def node_model(aggs, params, dropout=0.0, parity=True):
        m = NodeClassifier(F_IN, HID, N_CLASS, aggs, dropout_rate=dropout, parity=parity,
                           device="cpu")
        return node_classifier_from_jax(params, m)

    # Forwards.
    model = node_model(AGGS, inp["params"])
    fwd = make_node_sharded_forward(model, mesh, "node")
    with torch.no_grad():
        res["fwd"] = fwd(x, sgl).numpy()
        res["fwd_all"] = make_node_sharded_forward(
            node_model(ALL_AGGS, inp["params_all"], parity=False), mesh, "node")(x, sgl).numpy()

    # Gradients of the JAX test's loss, -Σ pick over the real rows / N,
    # by the rule: the replicated loss over the axis size, psum, one
    # all-reduce of the gradients.
    labels = local(inp["labels"][:N, None])[:, 0].long()
    pick = fwd(x, sgl).gather(1, labels[:, None])[:, 0]
    loss = -psum(torch.where(sgl.node_mask, pick, 0.0).sum(), group) / N
    (loss / size).backward()
    psum_grads(model.parameters())
    res["grads"] = grads_numpy(model)

    # One Adam step, dropout off.
    tmask = local(inp["tmask"][:N, None])[:, 0]
    model = node_model(AGGS, inp["params"])
    opt = make_optimizer(model.parameters(), 0.01, 5e-4)
    step = make_node_sharded_train_step(model, opt, mesh, "node", dropout=False)
    res["step_loss"] = float(step(x, sgl, labels, tmask))
    res["step_params"] = params_numpy(model)

    # Training with feature and mask dropout (0.3), per-rank generators.
    model = node_model(AGGS, inp["params_drop"], dropout=0.3)
    opt = make_optimizer(model.parameters(), 0.02)
    step = make_node_sharded_train_step(model, opt, mesh, "node", dropout=True)
    all_train = local(np.ones((N, 1), bool))[:, 0]
    drop_labels = local(inp["drop_labels"][:, None])[:, 0].long()
    res["dropout_losses"] = [float(step(x, sgl, drop_labels, all_train, seed=i))
                             for i in range(DROPOUT_STEPS)]

    # The LDG-ordered plan and forward.
    lg = graph_from_arrays(inp["ldg_graph"])
    sg_l, cuts_l, order = build_node_sharded_ordered(lg, size, "ldg")
    n_ml = sg_l.node_mask.shape[1]
    lmodel = NodeClassifier(LDG_F, HID, LDG_CLASS, AGGS, device="cpu")
    node_classifier_from_jax(inp["ldg_params"], lmodel)
    sgl_l = place_on_mesh(sg_l, mesh, "node")
    x_l = place_on_mesh(shard_node_values(inp["ldg_x"], cuts_l, n_ml, order=order), mesh, "node")
    with torch.no_grad():
        res["ldg_fwd"] = make_node_sharded_forward(lmodel, mesh, "node")(x_l, sgl_l).numpy()
    res["ldg_gids"] = sgl_l.global_ids.numpy()
    res["ldg_order"] = order
    write_rank_results(workdir, res)


# ------------------------------------------------------------- JAX side

def _ldg_graph():
    """``tests/test_partition.py::test_ordered_forward_matches_unsharded``'s graph."""
    from mma_tpu.graph.build import graph_from_edges

    rs = np.random.RandomState(0)
    a = (rs.rand(LDG_N, LDG_N) < 0.12).astype(np.float32)
    a = np.triu(a, 1)
    a = a + a.T
    dst, src = np.nonzero(a)
    g = graph_from_edges(src.astype(np.int32), dst.astype(np.int32), LDG_N)
    return g, rs.randn(LDG_N, LDG_F).astype(np.float32)


def _setup():
    import jax
    from helpers import random_symmetric_graph
    from mma_tpu.models import NodeClassifier

    _, _, graph = random_symmetric_graph(N, p=0.15, seed=5)
    rs = np.random.RandomState(2)
    x = np.zeros((graph.n_node, F_IN), np.float32)
    x[:N] = rs.randn(N, F_IN)
    rs = np.random.RandomState(7)
    labels = rs.randint(0, N_CLASS, N)
    tmask = np.zeros(N, bool)
    tmask[rs.choice(N, N_TRAIN_PICK, replace=False)] = True
    model = NodeClassifier(n_feat=F_IN, n_hidden=HID, n_class=N_CLASS, aggregators=AGGS,
                           dropout_rate=0.0)
    model_all = NodeClassifier(n_feat=F_IN, n_hidden=HID, n_class=N_CLASS,
                               aggregators=ALL_AGGS, dropout_rate=0.0, parity=False)
    ldg_g, ldg_x = _ldg_graph()
    ldg_model = NodeClassifier(n_feat=LDG_F, n_hidden=HID, n_class=LDG_CLASS, aggregators=AGGS)
    return dict(graph=graph, x=x, labels=labels, tmask=tmask, model=model,
                params=model.init(jax.random.PRNGKey(0)), model_all=model_all,
                params_all=model_all.init(jax.random.PRNGKey(2)),
                params_drop=model.init(jax.random.PRNGKey(1)),
                drop_labels=np.random.RandomState(9).randint(0, N_CLASS, N),
                halo_vals=np.random.RandomState(11).randn(N, HALO_F).astype(np.float32),
                ldg_graph=ldg_g, ldg_x=ldg_x, ldg_model=ldg_model,
                ldg_params=ldg_model.init(jax.random.PRNGKey(2)))


def _jax_side(s, w):
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from mma_tpu.parallel import make_mesh
    from mma_tpu.parallel.node_sharded import (
        build_node_sharded,
        halo_exchange,
        make_node_sharded_forward,
        make_node_sharded_train_step,
        place_on_mesh,
        shard_node_values,
        shard_spec,
    )
    from mma_tpu.train import make_optimizer

    mesh = make_mesh(("node",), devices=jax.devices("cpu")[:w])
    sg, cuts = build_node_sharded(s["graph"], w)
    n_m = sg.node_mask.shape[1]
    x_sh = shard_node_values(s["x"][:N], cuts, n_m)
    sgm = place_on_mesh(sg, mesh, "node")
    out = {"plan": {f: np.asarray(getattr(sg, f)) for f in _plan_fields()}, "cuts": cuts}

    exch = jax.jit(shard_map(
        lambda v, g: halo_exchange(v[0], jax.tree.map(lambda a: a[0], g), "node")[None],
        mesh=mesh, in_specs=(P("node"), shard_spec("node")), out_specs=P("node"),
        check_rep=False))
    v = shard_node_values(s["halo_vals"], cuts, n_m)
    halo, vjp = jax.vjp(lambda vv: exch(vv, sgm), v)
    ct = np.random.RandomState(13).randn(*halo.shape).astype(np.float32)
    out["halo"], out["halo_ct"] = np.asarray(halo), ct
    out["halo_grad"] = np.asarray(vjp(jnp.asarray(ct))[0])

    model, params = s["model"], s["params"]
    fwd = jax.jit(make_node_sharded_forward(model, mesh, "node"))
    out["fwd"] = np.asarray(fwd(params, x_sh, sgm))
    out["fwd_all"] = np.asarray(jax.jit(make_node_sharded_forward(s["model_all"], mesh, "node"))(
        s["params_all"], x_sh, sgm))
    labels_sh = shard_node_values(s["labels"].reshape(-1, 1), cuts, n_m)[..., 0]
    nmask = jnp.asarray(np.asarray(sg.node_mask))

    def sharded_loss(p):
        pick = jnp.take_along_axis(fwd(p, x_sh, sgm), labels_sh.astype(jnp.int32)[..., None],
                                   axis=-1)[..., 0]
        return -jnp.sum(jnp.where(nmask, pick, 0.0)) / N

    out["grads"] = numpy_tree(jax.jit(jax.grad(sharded_loss))(params))
    tmask_sh = shard_node_values(s["tmask"].reshape(-1, 1), cuts, n_m)[..., 0]
    opt = make_optimizer(learning_rate=0.01, weight_decay=5e-4)
    step = make_node_sharded_train_step(model, opt, mesh, "node", dropout=False)
    p_new, _, loss = step(params, opt.init(params), x_sh, sgm, labels_sh, tmask_sh)
    out["step_loss"], out["step_params"] = float(loss), numpy_tree(p_new)
    return out


@pytest.fixture(scope="module")
def setup():
    return _setup()


@pytest.fixture(scope="module", params=WORLDS, ids=[f"W{w}" for w in WORLDS])
def world(request, setup, tmp_path_factory):
    w = request.param
    s = setup
    want = _jax_side(s, w)
    inputs = dict(graph=graph_arrays(s["graph"]), x=s["x"], labels=s["labels"],
                  tmask=s["tmask"], params=numpy_tree(s["params"]),
                  params_all=numpy_tree(s["params_all"]),
                  params_drop=numpy_tree(s["params_drop"]), drop_labels=s["drop_labels"],
                  halo_vals=s["halo_vals"], halo_ct=want["halo_ct"],
                  ldg_graph=graph_arrays(s["ldg_graph"]), ldg_x=s["ldg_x"],
                  ldg_params=numpy_tree(s["ldg_params"]))
    ranks = run_world("test_torch_node_sharded:node_worker", w, inputs,
                      str(tmp_path_factory.mktemp(f"node_world{w}")))
    return w, ranks, want


# ----------------------------------------------------------------- tests

def _flat(tree):
    """``{"gc1": {"w": a}}`` → ``{"gc1.w": a}``: the port's parameter names."""
    return {f"{k}.{n}": v for k, sub in tree.items() for n, v in sub.items()}


def _replicated(ranks, key):
    """Rank 0's value of ``key``, after checking every rank's is bitwise equal."""
    first = ranks[0][key]
    for r, res in enumerate(ranks[1:], 1):
        if isinstance(first, dict):
            for name, v in first.items():
                np.testing.assert_array_equal(res[key][name], v, err_msg=f"rank {r} {key} {name}")
        else:
            np.testing.assert_array_equal(np.asarray(res[key]), np.asarray(first),
                                          err_msg=f"rank {r} {key}")
    return first


def _torch_graph(g):
    return graph_from_arrays(graph_arrays(g))


def _hold_plan(got, want, cuts_got, cuts_want, what):
    np.testing.assert_array_equal(cuts_got, cuts_want, err_msg=f"{what} cuts")
    assert cuts_got.dtype == cuts_want.dtype, what
    for f in _plan_fields():
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, (what, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {f}")


def _locality():
    from test_partition import _locality_graph

    return _locality_graph()


@pytest.mark.parametrize("graph_name", ["test_parallel", "locality"])
@pytest.mark.parametrize("shards", PLAN_SHARDS)
def test_plan_matches_jax(setup, graph_name, shards):
    """``build_node_sharded`` equals the JAX plan field for field, bit for
    bit: the same cuts, row and edge pads, halo slots, boundary lists and
    local CSRs (``test_parallel.py``'s graph and ``test_partition.py``'s
    ring-local graph, 2, 4 and 8 shards)."""
    from mma_tpu.parallel.node_sharded import build_node_sharded as jax_build
    from mma_tpu_torch.parallel import build_node_sharded

    g = setup["graph"] if graph_name == "test_parallel" else _locality()
    sg, cuts = build_node_sharded(_torch_graph(g), shards)
    want, want_cuts = jax_build(g, shards)
    _hold_plan(sg, want, cuts, want_cuts, f"{graph_name} S={shards}")


@pytest.mark.parametrize("method", ["contiguous", "ldg"])
@pytest.mark.parametrize("shards", PLAN_SHARDS)
def test_ordered_plan_matches_jax(setup, method, shards):
    """``build_node_sharded_ordered`` (and ``partition_order`` under it) on
    both graphs: the same order, cuts and plan as the JAX package's, with
    ``global_ids`` mapped back to original ids."""
    from mma_tpu.parallel.node_sharded import build_node_sharded_ordered as jax_build
    from mma_tpu_torch.parallel import build_node_sharded_ordered, partition_order

    for g in (setup["graph"], _locality()):
        tg = _torch_graph(g)
        sg, cuts, order = build_node_sharded_ordered(tg, shards, method)
        want, want_cuts, want_order = jax_build(g, shards, method)
        np.testing.assert_array_equal(order, want_order)
        assert order.dtype == want_order.dtype
        np.testing.assert_array_equal(partition_order(tg, shards, method), want_order)
        _hold_plan(sg, want, cuts, want_cuts, f"{method} S={shards}")


def test_shard_node_values_match_jax(setup):
    """``shard_node_values`` (features, labels as a column, a bool mask;
    with and without an order) equals the JAX stack bit for bit."""
    import jax
    from mma_tpu.parallel.node_sharded import (
        build_node_sharded_ordered as jax_build,
        shard_node_values as jax_values,
    )
    from mma_tpu_torch.parallel import shard_node_values

    _, cuts, order = jax_build(setup["graph"], 4, "ldg")
    for vals in (setup["x"][:N], setup["labels"].reshape(-1, 1),
                 setup["tmask"].reshape(-1, 1)):
        for o in (None, order):
            got, want = shard_node_values(vals, cuts, 20, order=o), np.asarray(
                jax_values(vals, cuts, 20, order=o))
            # JAX narrows 64-bit values to 32 bits (x64 off); numpy keeps them.
            assert isinstance(got, np.ndarray)
            assert jax.dtypes.canonicalize_dtype(got.dtype) == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shards", (4, 8))
def test_ldg_cuts_the_boundary_and_balances(shards):
    """The JAX test's rule (``test_partition.py:113-128``) on the port's
    plans: on the ring-local graph the LDG order's boundary fraction is
    under half the contiguous cuts', edges are balanced within 15%, and
    the order is a permutation of the real nodes."""
    from mma_tpu_torch.graph import native
    from mma_tpu_torch.parallel import build_node_sharded_ordered

    assert native.available()
    g = _torch_graph(_locality())
    sg_c, _, _ = build_node_sharded_ordered(g, shards, "contiguous")
    sg_l, _, order = build_node_sharded_ordered(g, shards, "ldg")

    def bf(sg):
        return sg.bnd_mask.sum() / sg.edge_mask.sum()

    assert bf(sg_l) < bf(sg_c) / 2, (bf(sg_l), bf(sg_c))
    e_tot = sg_l.edge_mask.sum(1)
    assert e_tot.max() <= 1.15 * e_tot.mean()
    assert np.array_equal(np.sort(order), np.arange(int(g.node_mask.sum())))


def test_halo_exchange_matches_jax(world):
    """Each rank receives, bit for bit, the flat halo buffer the JAX
    ``halo_exchange`` gives its shard under ``shard_map`` (it only moves
    rows)."""
    w, ranks, want = world
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["halo"], want["halo"][r], err_msg=f"rank {r}")


def test_halo_exchange_backward_is_the_reverse_exchange(world, setup):
    """The exchange's backward routes each halo row's cotangent home: each
    rank's gradient equals the JAX VJP's row of the same cotangent, and
    ``Σ out·ct`` over the ranks equals ``Σ values·grad`` (the adjoint
    identity of a permutation with zeros), within 1e-6."""
    w, ranks, want = world
    dot_out = sum(res["halo_dot"] for res in ranks)
    dot_in = 0.0
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["halo_grad"], want["halo_grad"][r], rtol=1e-6, atol=1e-6,
                                   err_msg=f"rank {r}")
        lo, hi = want["cuts"][r], want["cuts"][r + 1]
        dot_in += float((setup["halo_vals"][lo:hi] * res["halo_grad"][:hi - lo]).sum())
    assert abs(dot_out - dot_in) <= 1e-6 * max(1.0, abs(dot_out)), (dot_out, dot_in)


def test_all_to_all_counters(world):
    """``collectives.STATS`` after one exchange: one all-to-all of the
    bytes each rank hands over, ``S·H_m·F·4``; the backward adds one more
    of the same size."""
    w, ranks, want = world
    h_m = want["plan"]["send_idx"].shape[2]
    nbytes = w * h_m * HALO_F * 4
    for res in ranks:
        assert res["stats_fwd"]["all_to_all_calls"] == 1
        assert res["stats_fwd"]["all_to_all_bytes"] == nbytes
        assert res["stats_bwd"]["all_to_all_calls"] == 2
        assert res["stats_bwd"]["all_to_all_bytes"] == 2 * nbytes
        assert res["stats_fwd"]["all_reduce_calls"] == 0


def _unsharded(model_cls_kw, params, x, graph):
    from mma_tpu_torch.convert import node_classifier_from_jax
    from mma_tpu_torch.models import NodeClassifier

    m = node_classifier_from_jax(numpy_tree(params), NodeClassifier(**model_cls_kw, device="cpu"))
    with torch.no_grad():
        return m(torch.from_numpy(x), _torch_graph(graph)).numpy()


def _hold_forward(ranks, want, key, full, plan):
    ids, mask = plan["global_ids"], plan["node_mask"]
    for r, res in enumerate(ranks):
        got = res[key][mask[r]]
        for ref, what in ((want[key][r][mask[r]], "jax"), (full[ids[r][mask[r]]], "unsharded")):
            np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4,
                                       err_msg=f"rank {r} {key} vs {what}")
            # The tighter figure that holds.
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {r} {key} vs {what} (1e-5)")


def test_forward_matches_jax_and_unsharded(world, setup):
    """The node-sharded forward (``mean,min2,max``) on every rank equals the
    JAX node-sharded forward's shard and the port's unsharded forward on
    the rank's rows."""
    w, ranks, want = world
    kw = dict(n_feat=F_IN, n_hidden=HID, n_class=N_CLASS, aggregators=AGGS, dropout_rate=0.0)
    full = _unsharded(kw, setup["params"], setup["x"], setup["graph"])
    _hold_forward(ranks, want, "fwd", full, want["plan"])


def test_all_combines_match_jax_and_unsharded(world, setup):
    """Every fixed-mode combine (``std``, ``normalized_mean`` and
    ``moment_3``'s two-pass form included, ``parity=False`` so the scalers
    read the global mean log-degree) node-sharded
    (``test_parallel.py:361-394``)."""
    w, ranks, want = world
    kw = dict(n_feat=F_IN, n_hidden=HID, n_class=N_CLASS, aggregators=ALL_AGGS,
              dropout_rate=0.0, parity=False)
    full = _unsharded(kw, setup["params_all"], setup["x"], setup["graph"])
    _hold_forward(ranks, want, "fwd_all", full, want["plan"])


def test_gradients_match_jax(world):
    """The gradients of ``-Σ pick / N`` over the real rows, by the rule
    (``psum`` of the local sums, ``loss / S`` backpropagated, one
    all-reduce of the gradients), equal the JAX gradient through
    ``shard_map`` on every rank (``test_parallel.py:186-223``)."""
    _, ranks, want = world
    got = _replicated(ranks, "grads")
    for name, w in _flat(want["grads"]).items():
        np.testing.assert_allclose(got[name], w, rtol=3e-4, atol=1e-5, err_msg=name)


def test_train_step_matches_jax_and_unsharded(world, setup):
    """One ``make_node_sharded_train_step`` (dropout off, Adam-L2): the JAX
    node-sharded step's loss and parameters, and the port's unsharded
    step's (``test_parallel.py:246-315``)."""
    from mma_tpu_torch.convert import node_classifier_from_jax
    from mma_tpu_torch.models import NodeClassifier
    from mma_tpu_torch.train import make_optimizer

    _, ranks, want = world
    loss = _replicated(ranks, "step_loss")
    params = _replicated(ranks, "step_params")
    m = node_classifier_from_jax(numpy_tree(setup["params"]), NodeClassifier(
        F_IN, HID, N_CLASS, AGGS, dropout_rate=0.0, device="cpu"))
    opt = make_optimizer(m.parameters(), 0.01, 5e-4)
    logp = m(torch.from_numpy(setup["x"]), _torch_graph(setup["graph"]), training=True)[:N]
    tmask = torch.from_numpy(setup["tmask"])
    pick = logp.gather(1, torch.from_numpy(setup["labels"])[:, None].long())[:, 0]
    ref_loss = -torch.where(tmask, pick, 0.0).sum() / tmask.sum()
    ref_loss.backward()
    opt.step()
    ref_params = {n: p.detach().numpy() for n, p in m.named_parameters()}
    for what, l_ref, p_ref in (("jax", want["step_loss"], _flat(want["step_params"])),
                               ("unsharded", float(ref_loss.detach()), ref_params)):
        np.testing.assert_allclose(loss, l_ref, rtol=1e-5, err_msg=what)
        for name, w in p_ref.items():
            np.testing.assert_allclose(params[name], w, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{what} {name}")


def test_training_with_dropout_learns(world):
    """Feature and mask dropout (0.3) from per-rank generators, 30 Adam
    steps: the ranks stay in step (bitwise equal losses) and the last loss
    is under 0.9 of the first (``test_parallel.py:318-357``)."""
    _, ranks, _ = world
    losses = _replicated(ranks, "dropout_losses")
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < 0.9 * losses[0], (losses[0], losses[-1])


def test_ldg_ordered_forward_matches_unsharded(world, setup):
    """The LDG-ordered plan (``test_partition.py:130-174``'s graph and
    model): each rank's rows, put back by ``global_ids``, equal the
    unsharded forward within atol 2e-4; the order is not the identity."""
    _, ranks, _ = world
    kw = dict(n_feat=LDG_F, n_hidden=HID, n_class=LDG_CLASS, aggregators=AGGS)
    g = setup["ldg_graph"]
    x_full = np.vstack([setup["ldg_x"], np.zeros((g.n_node - LDG_N, LDG_F), np.float32)])
    full = _unsharded(kw, setup["ldg_params"], x_full, g)[:LDG_N]
    assert not np.array_equal(ranks[0]["ldg_order"], np.arange(LDG_N))
    got = np.zeros((LDG_N, LDG_CLASS), np.float32)
    for res in ranks:
        v = res["ldg_gids"] >= 0
        got[res["ldg_gids"][v]] = res["ldg_fwd"][v]
    np.testing.assert_allclose(got, full, atol=2e-4)


def test_all_to_all_in_a_world_of_one_and_the_smoke_report():
    """``all_to_all`` with no axis is the identity; in a world of one (a
    gloo group of this process) it returns the rows unchanged, counts one
    call of the bytes handed over, differentiates as the identity, and
    ``chip_smoke.collective_stats`` reports the counters."""
    import chip_smoke
    from mma_tpu_torch.parallel import all_to_all, collectives

    x = torch.arange(24, dtype=torch.float32).reshape(6, 4).requires_grad_()
    assert all_to_all(x, None) is x
    with world_of_one() as mesh:
        group = mesh.get_group("edge")
        collectives.reset_stats()
        out = all_to_all(x, group)
        (out * 2).sum().backward()
        line = chip_smoke.collective_stats()
    np.testing.assert_array_equal(out.detach().numpy(), x.detach().numpy())
    np.testing.assert_array_equal(x.grad.numpy(), np.full((6, 4), 2.0, np.float32))
    assert collectives.STATS["all_to_all_calls"] == 2  # the exchange and its reverse
    assert collectives.STATS["all_to_all_bytes"] == 2 * 24 * 4
    assert "all_to_all 2 calls / 192 B" in line, line
