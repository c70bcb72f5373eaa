"""The port's edge-parallel and data-parallel regimes against the JAX
package, on gloo worlds of 2 and 4 CPU processes.

``mma_tpu_torch.parallel`` runs one process per rank; the JAX package runs
the same regime in this process on a mesh of the same size, from the first
W of the 8 forced host devices (``tests/conftest.py``), on its XLA path
(``use_pallas=False``). Inputs come from numpy seeds; parameters go through
``mma_tpu_torch.convert``. Each world runs once per module and size
(:func:`world`): every rank runs :func:`edge_worker` over all the cases
and writes its results. The ranks import this module, so it imports JAX
and ``mma_tpu`` only inside the functions that compute the JAX side.

Mirrors ``tests/test_parallel.py:45-146`` and ``:226-250`` with the JAX
package's tolerances: forwards within rtol = atol = 1e-5, gradients rtol
2e-4 and atol 1e-5. After 3 Adam steps (dropout off): losses within 1e-5
relative, parameters within rtol 2e-4 and atol 1e-4 (a tenth of one
lr = 1e-3 update; ``tests/test_dp_edge.py``'s rule: Adam's g/√v amplifies
the reordering of f32 sums on near-zero gradients) and BatchNorm buffers
within rtol 1e-4, atol 1e-5. For ZincNet the first step's summed
gradients are held at the gradient tolerance (``torch_world.hold_zinc_grads``)
and the parameters by ``torch_world.hold_adam_params``: that tolerance where
the first step's gradient is not a small fraction of its tensor's, 2·lr·steps
elsewhere, as ``tests/test_torch_zinc_net.py`` holds 3 Adam steps; the
BatchNorm buffers after the first step at the buffer tolerance, and the
running means after 3 steps within the drift of the BatchNorm-fed biases
they average. Dropout is tested as "runs and learns".
Replicated results (forwards, losses, parameters) must be bitwise equal on
every rank.
"""

import numpy as np
import pytest
import torch

from torch_world import (
    GRAPH_FIELDS,
    grads_numpy,
    graph_arrays,
    hold_adam_params,
    hold_shares,
    hold_zinc_grads,
    graph_from_arrays,
    numpy_tree,
    params_numpy,
    rank_inputs,
    run_world,
    summed_shares,
    write_rank_results,
)

pytestmark = pytest.mark.multichip

N, F_IN, HID, N_CLASS = 60, 12, 16, 4
AGGS = ("mean", "max2", "min")
N_TRAIN, STEPS, DROPOUT_STEPS = 40, 3, 10
ZINC_AGGS = (("min", "max"), ("identity", "amplification", "linear"))
ZINC_KW = dict(towers=1, num_layers=2)
ZINC_PAD = dict(n_node=4 * 40, n_edge=4 * 100)
WORLDS = (2, 4)


# ------------------------------------------------------------------ ranks

def edge_worker(workdir):
    """One rank: every case of this module over the inputs in ``workdir``."""
    from mma_tpu_torch.convert import node_classifier_from_jax, zinc_net_from_jax
    from mma_tpu_torch.data import load_zinc
    from mma_tpu_torch.models import NodeClassifier, ZincNet
    from mma_tpu_torch.parallel import (
        all_gather,
        axis_index,
        initialize_distributed,
        make_dp_train_step,
        make_edge_sharded_forward,
        make_edge_sharded_train_step,
        make_mesh,
        pmean,
        psum,
        psum_grads,
        shard_graph,
        shard_stacked_batch,
        stack_batches,
    )
    from mma_tpu_torch.train import make_optimizer

    initialize_distributed("cpu")
    # Replicated results are compared bitwise across the ranks.
    torch.use_deterministic_algorithms(True)
    inp = rank_inputs(workdir)
    mesh = make_mesh(("edge",))
    group = mesh.get_group("edge")
    size = mesh.size()
    graph = graph_from_arrays(inp["graph"])
    x = torch.from_numpy(inp["x"])
    labels, idx = torch.from_numpy(inp["labels"]).long(), torch.arange(N_TRAIN)

    def node_model(dropout):
        m = NodeClassifier(F_IN, HID, N_CLASS, AGGS, dropout_rate=dropout, device="cpu")
        return node_classifier_from_jax(inp["node_params"], m)

    # The collectives alone: this rank's index, and a value that is its rank.
    r = torch.tensor([float(axis_index(group))], requires_grad=True)
    summed, mean, stacked = psum(r, group), pmean(r, group), all_gather(r, group)
    (summed + 2 * mean + (3 * stacked).sum()).backward()
    res = {"axis_index": axis_index(group), "psum": summed.item(), "pmean": mean.item(),
           "all_gather": stacked.detach().numpy()[:, 0], "collective_grad": r.grad.item()}
    for ks in (False, True):
        shard = shard_graph(graph, mesh, "edge", kernel_structure=ks)
        res[f"shard_{ks}"] = graph_arrays(shard)
        model = node_model(0.0)
        with torch.no_grad():
            res[f"fwd_{ks}"] = make_edge_sharded_forward(model, mesh, "edge")(x, shard).numpy()
        logp = model(x, shard, training=True, axis_name=group)
        (-logp[idx, labels[idx]].mean() / size).backward()
        psum_grads(model.parameters())
        res[f"grads_{ks}"] = grads_numpy(model)

        model = node_model(0.0)
        opt = make_optimizer(model.parameters(), 0.01, 1e-4)
        step = make_edge_sharded_train_step(model, opt, mesh, labels, idx, "edge")
        res[f"losses_{ks}"] = [float(step(x, shard)) for _ in range(STEPS)]
        res[f"params_{ks}"] = params_numpy(model)

    # Dropout on (0.5): the same generator seed on every rank.
    model = node_model(0.5)
    opt = make_optimizer(model.parameters(), 0.01, 1e-4)
    step = make_edge_sharded_train_step(model, opt, mesh, labels, idx, "edge")
    gen = torch.Generator().manual_seed(7)
    shard = shard_graph(graph, mesh, "edge", kernel_structure=True)
    res["dropout_losses"] = [float(step(x, shard, gen)) for _ in range(DROPOUT_STEPS)]

    # ZINC data parallelism: one micro-batch of 4 molecules per rank.
    dmesh = make_mesh(("data",))
    ds = load_zinc("val", subset_size=size * 4)
    micro = list(ds.batches(4, device="cpu", **ZINC_PAD))[:size]
    net = ZincNet(*ZINC_AGGS, inp["zinc_avg"], device="cpu", **ZINC_KW)
    zinc_net_from_jax(inp["zinc_params"], inp["zinc_state"], net)
    opt = make_optimizer(net.parameters(), 1e-3, 3e-4)
    step = make_dp_train_step(net, opt, dmesh, "data")
    batch = shard_stacked_batch(stack_batches(micro), dmesh, device="cpu")
    res["zinc_losses"] = [float(step(batch))]
    res["zinc_grads1"] = grads_numpy(net)  # the first step's summed gradients
    res["zinc_buffers1"] = {n: b.numpy().copy() for n, b in net.named_buffers()}
    res["zinc_losses"] += [float(step(batch)) for _ in range(STEPS - 1)]
    res["zinc_params"] = params_numpy(net)
    res["zinc_buffers"] = {n: b.numpy().copy() for n, b in net.named_buffers()}
    write_rank_results(workdir, res)


# ------------------------------------------------------------- JAX side

def _setup():
    import jax
    import jax.numpy as jnp
    from helpers import random_symmetric_graph
    from mma_tpu.data import load_zinc
    from mma_tpu.models import NodeClassifier, ZincNet
    from mma_tpu.nn.mma_conv import compute_avg_deg

    _, _, graph = random_symmetric_graph(N, p=0.15, seed=5)
    rs = np.random.RandomState(2)
    x = np.zeros((graph.n_node, F_IN), np.float32)
    x[:N] = rs.randn(N, F_IN)
    labels = np.random.RandomState(3).randint(0, N_CLASS, graph.n_node).astype(np.int32)
    model = NodeClassifier(n_feat=F_IN, n_hidden=HID, n_class=N_CLASS, aggregators=AGGS,
                           dropout_rate=0.0)
    params = model.init(jax.random.PRNGKey(0))
    ds = load_zinc("val", subset_size=8 * 4)
    avg = compute_avg_deg(jnp.asarray(ds.degree_histogram()), parity=True)
    znet = ZincNet(aggregators=ZINC_AGGS[0], scalers=ZINC_AGGS[1],
                   avg_deg=tuple(avg.items()), **ZINC_KW)
    zparams, zstate = znet.init(jax.random.PRNGKey(0)), znet.init_state()
    return dict(graph=graph, x=x, labels=labels, model=model, params=params, znet=znet,
                zparams=zparams, zstate=zstate, avg={k: float(v) for k, v in avg.items()})


class _NoDropout:
    """The JAX ZincNet with its dropout rng dropped (the DP step always
    passes one)."""

    def __init__(self, net):
        self.net = net

    def apply(self, params, state, batch, *, training, rng):
        del rng
        return self.net.apply(params, state, batch, training=training)


def _jax_side(s, w):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from mma_tpu.data import load_zinc
    from mma_tpu.parallel import (
        make_dp_train_step,
        make_edge_sharded_forward,
        make_edge_sharded_train_step,
        make_mesh,
        shard_graph,
        stack_batches,
    )
    from mma_tpu.parallel.edge_parallel import graph_shard_spec
    from mma_tpu.train import make_optimizer

    model, params, graph = s["model"], s["params"], s["graph"]
    x, labels, idx = jnp.asarray(s["x"]), jnp.asarray(s["labels"]), jnp.arange(N_TRAIN)
    mesh = make_mesh(("edge",), devices=jax.devices()[:w])
    g_sh = shard_graph(graph, mesh, "edge")
    fwd = jax.jit(make_edge_sharded_forward(model, mesh, "edge"))
    out = {"fwd": np.asarray(fwd(params, x, g_sh))}
    fwd = shard_map(
        lambda p, xx, gg: model.apply(p, xx, gg, training=True, rng=None, axis_name="edge"),
        mesh=mesh, in_specs=(P(), P(), graph_shard_spec("edge")), out_specs=P(),
        check_rep=False)
    out["grads"] = numpy_tree(jax.jit(jax.grad(
        lambda p: -jnp.mean(fwd(p, x, g_sh)[idx, labels[idx]])))(params))
    out["shard_ks"] = graph_arrays(shard_graph(graph, mesh, "edge", kernel_structure=True))
    out["shard"] = graph_arrays(g_sh)
    opt = make_optimizer(0.01, weight_decay=1e-4)
    step = make_edge_sharded_train_step(model, opt, mesh, labels, idx, "edge")
    p, o, losses = params, opt.init(params), []
    for i in range(STEPS):
        p, o, loss = step(p, o, x, g_sh, jax.random.PRNGKey(i))
        losses.append(float(loss))
    out["losses"], out["params"] = losses, numpy_tree(p)

    dmesh = make_mesh(("data",), devices=jax.devices()[:w])
    micro = list(load_zinc("val", subset_size=w * 4).batches(4, **ZINC_PAD))[:w]
    stacked, rngs = stack_batches(micro), jax.random.split(jax.random.PRNGKey(1), w)
    # Adam, with the gradients of each step kept in the optimizer state.
    adam = make_optimizer(1e-3, weight_decay=3e-4)
    opt = optax.GradientTransformation(
        lambda p: (adam.init(p), jax.tree.map(jnp.zeros_like, p)),
        lambda g, st, p=None: (lambda u, a: (u, (a, g)))(*adam.update(g, st[0], p)))
    step = make_dp_train_step(_NoDropout(s["znet"]), opt, dmesh, "data")
    zp, zs, zo, losses = s["zparams"], s["zstate"], opt.init(s["zparams"]), []
    for i in range(STEPS):
        zp, zs, zo, loss = step(zp, zs, zo, stacked, rngs)
        losses.append(float(loss))
        if i == 0:
            out["zinc_state1"], out["zinc_grads1"] = numpy_tree(zs), numpy_tree(zo[1])
    out["zinc_losses"], out["zinc_params"], out["zinc_state"] = (
        losses, numpy_tree(zp), numpy_tree(zs))
    return out


@pytest.fixture(scope="module")
def setup():
    return _setup()


@pytest.fixture(scope="module", params=WORLDS, ids=[f"W{w}" for w in WORLDS])
def world(request, setup, tmp_path_factory):
    w = request.param
    s = setup
    inputs = dict(graph=graph_arrays(s["graph"]), x=s["x"], labels=s["labels"],
                  node_params=numpy_tree(s["params"]), zinc_params=numpy_tree(s["zparams"]),
                  zinc_state=numpy_tree(s["zstate"]),
                  zinc_avg=s["avg"])
    ranks = run_world("test_torch_parallel:edge_worker", w, inputs,
                      str(tmp_path_factory.mktemp(f"edge_world{w}")))
    return w, ranks, _jax_side(s, w)


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


@pytest.mark.parametrize("ks", [False, True], ids=["no_structure", "kernel_structure"])
def test_edge_sharded_forward_matches_jax(world, ks):
    """The sharded forward on every rank equals the JAX package's sharded
    forward on a mesh of the same size (``tests/test_parallel.py:45-54``),
    with and without the per-shard kernel structure (the lean and the
    half-fused route)."""
    _, ranks, want = world
    np.testing.assert_allclose(_replicated(ranks, f"fwd_{ks}")[:N], want["fwd"][:N],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ks", [False, True], ids=["no_structure", "kernel_structure"])
def test_edge_sharded_gradients_match_jax(world, ks):
    """Each rank's share of the NLL, the in-graph ``psum``s and one
    all-reduce of the gradients give the JAX package's gradient through
    ``shard_map`` (``tests/test_parallel.py:57-96``) on every rank."""
    _, ranks, want = world
    got = _replicated(ranks, f"grads_{ks}")
    for name, w in _flat(want["grads"]).items():
        np.testing.assert_allclose(got[name], w, rtol=2e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("ks", [False, True], ids=["no_structure", "kernel_structure"])
def test_edge_sharded_train_steps_match_jax(world, ks):
    """3 Adam steps of ``make_edge_sharded_train_step`` (dropout off):
    the JAX step's losses and parameters, and the loss falls."""
    _, ranks, want = world
    losses = _replicated(ranks, f"losses_{ks}")
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    assert losses[-1] < losses[0], losses
    got = _replicated(ranks, f"params_{ks}")
    for name, w in _flat(want["params"]).items():
        np.testing.assert_allclose(got[name], w, rtol=2e-4, atol=1e-4, err_msg=name)


def test_edge_sharded_train_step_with_dropout_learns(world):
    """Mask and feature dropout (0.5) from one generator seed on every
    rank: the ranks stay in step (bitwise equal losses) and the loss falls
    over 10 steps (``tests/test_parallel.py:99-113``)."""
    _, ranks, _ = world
    losses = _replicated(ranks, "dropout_losses")
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


@pytest.mark.parametrize("ks", [False, True], ids=["no_structure", "kernel_structure"])
def test_shards_match_jax_shard_graph(world, ks):
    """Rank r's shard holds the JAX package's edge slice r and, with
    ``kernel_structure``, row r of its stacked per-shard CSR and CSC, field
    for field; without it, no CSC (and a CSR of its own edges). The fields
    it holds are those ``graph_shard_spec`` names."""
    from mma_tpu_torch.parallel import graph_shard_spec

    w, ranks, want = world
    jax_ks = want["shard_ks"]
    for r, res in enumerate(ranks):
        got = res[f"shard_{ks}"]
        e_loc = jax_ks["src"].shape[0] // w
        for f in ("src", "dst", "edge_mask"):
            np.testing.assert_array_equal(got[f], jax_ks[f][r * e_loc:(r + 1) * e_loc],
                                          err_msg=f"rank {r} {f}")
        for f in ("node_mask", "deg"):
            np.testing.assert_array_equal(got[f], jax_ks[f], err_msg=f"rank {r} {f}")
        np.testing.assert_array_equal(got["row_ptr"], jax_ks["row_ptr"][r], err_msg="row_ptr")
        spec = graph_shard_spec("edge", ks)
        assert all((got[f] is None) == (spec[f] is None) for f in GRAPH_FIELDS)
        for f in ("src_perm", "col_ptr", "src_csc", "dst_csc"):
            if ks:
                np.testing.assert_array_equal(got[f], jax_ks[f][r], err_msg=f"rank {r} {f}")
                assert got[f].dtype == jax_ks[f].dtype, f
            else:
                assert got[f] is None and want["shard"][f] is None, f


def test_pad_graph_matches_jax(setup):
    """``pad_graph`` against the JAX package's, field for field, on the
    edge padding the sharding asks for."""
    from mma_tpu.graph.build import pad_graph as jax_pad_graph
    from mma_tpu_torch.graph.build import pad_graph

    g = setup["graph"]
    tg = graph_from_arrays(graph_arrays(g))
    for n_node, n_edge in ((g.n_node, g.n_edge + 3), (g.n_node + 8, g.n_edge + 64)):
        got, want = pad_graph(tg, n_node, n_edge, device="cpu"), jax_pad_graph(g, n_node, n_edge)
        for f in GRAPH_FIELDS:
            a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_dp_zinc_steps_match_jax(world, setup):
    """3 data-parallel ZINC steps (``min,max``, one micro-batch of 4
    molecules per rank, dropout off): the JAX ``make_dp_train_step`` on a
    mesh of the same size gives the same global losses, parameters and
    averaged BatchNorm buffers (``tests/test_parallel.py:115-146``), the
    first step's summed gradients equal the JAX step's, and the loss
    falls."""
    _, ranks, want = world
    losses = _replicated(ranks, "zinc_losses")
    np.testing.assert_allclose(losses, want["zinc_losses"], rtol=1e-5)
    assert losses[-1] < losses[0], losses
    from mma_tpu_torch.convert import zinc_net_from_jax
    from mma_tpu_torch.models import ZincNet

    # The JAX trees in the port's names: load them into a port model.
    ref = ZincNet(*ZINC_AGGS, dict(setup["avg"]), device="cpu", **ZINC_KW)
    zinc_net_from_jax(want["zinc_params"], want["zinc_state"], ref)
    want_params = {n: p.detach().numpy().copy() for n, p in ref.named_parameters()}
    zinc_net_from_jax(want["zinc_grads1"], want["zinc_state"], ref)  # the same names
    grads1 = {n: p.detach().numpy().copy() for n, p in ref.named_parameters()}
    zinc_net_from_jax(want["zinc_params"], want["zinc_state"], ref)
    hold_zinc_grads(_replicated(ranks, "zinc_grads1"), grads1)
    hold_adam_params(_replicated(ranks, "zinc_params"), want_params, grads1, 1e-3, STEPS)
    # The averaged BatchNorm buffers after the first step, where both sides
    # average the same batch statistics; after 3 steps the running variances
    # (a per-channel constant does not move them) at the same tolerance, and
    # the running means within 0.1·(0.9 + 1)·2·lr·steps: they average conv
    # outputs that carry the BatchNorm-fed biases, each within 2·lr·steps.
    for key, state in (("zinc_buffers1", want["zinc_state1"]), ("zinc_buffers", None)):
        if state is not None:
            zinc_net_from_jax(want["zinc_params"], state, ref)
        else:
            zinc_net_from_jax(want["zinc_params"], want["zinc_state"], ref)
        bufs = _replicated(ranks, key)
        for name, b in ref.named_buffers():
            drift = key == "zinc_buffers" and name.endswith(".mean")
            np.testing.assert_allclose(bufs[name], b.numpy(), rtol=1e-4,
                                       atol=0.19 * 2 * 1e-3 * STEPS if drift else 1e-5,
                                       err_msg=f"{key} {name}")


def test_dp_zinc_gradients_sum_the_ranks_shares(world, setup):
    """The data-parallel step's first gradients are the sum of the
    micro-batches' shares (each error sum over the global graph count),
    computed one after the other in this process: the gradient rule of
    ``mma_tpu_torch.parallel.collectives``, with no JAX in between."""
    from mma_tpu_torch.convert import zinc_net_from_jax
    from mma_tpu_torch.data import load_zinc
    from mma_tpu_torch.models import ZincNet

    w, ranks, _ = world
    net = ZincNet(*ZINC_AGGS, dict(setup["avg"]), device="cpu", **ZINC_KW)
    zinc_net_from_jax(numpy_tree(setup["zparams"]), numpy_tree(setup["zstate"]), net)
    micro = list(load_zinc("val", subset_size=w * 4).batches(4, device="cpu", **ZINC_PAD))[:w]

    def l1_sum(m, b):
        gm = b.graph_mask.float()
        return (torch.abs(m(b, training=True) - b.target) * gm).sum(), gm.sum()

    hold_shares(_replicated(ranks, "zinc_grads1"), summed_shares(net, micro, l1_sum))


def test_collectives_sum_gather_and_differentiate_as_sums(world):
    """``axis_index``, ``psum``, ``pmean`` and ``all_gather`` over the edge
    axis, and their backward by the gradient rule: each rank's cotangent of
    ``psum(r) + 2·pmean(r) + Σ 3·all_gather(r)`` sums the same term over
    every rank, W + 2 + 3·W."""
    w, ranks, _ = world
    for rank, res in enumerate(ranks):
        assert res["axis_index"] == rank
        assert res["psum"] == sum(range(w)) and res["pmean"] == sum(range(w)) / w
        np.testing.assert_array_equal(res["all_gather"], np.arange(w, dtype=np.float32))
        assert res["collective_grad"] == w + 2 + 3 * w
