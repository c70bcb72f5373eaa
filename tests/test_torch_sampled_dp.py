"""The port's data-parallel sampled step against the JAX package, on gloo
worlds of 2 and 4 CPU processes.

The subgraphs are sampled here, once, by both packages' samplers (bit for
bit equal, ``tests/test_torch_sampling.py``) from the same seed rows; rank
r of the world trains on the port's piece r, and the JAX package's
``make_sampled_dp_step`` runs on a mesh of the same size (the first W of
the 8 forced host devices, its XLA path) on its stack. Each world runs once
per size (:func:`world`), every rank running :func:`sampled_worker` over all
the cases; the ranks import this module, so JAX and ``mma_tpu`` are
imported only inside the functions that compute the JAX side.

Tolerances, as ``tests/test_torch_parallel.py``: the loss within 1e-5
relative, gradients within rtol 2e-4 and atol 1e-5, the summed gradients
against the ranks' shares computed one after the other within 1e-6 of each
tensor's largest. ``stack_graphs`` and ``stack_sampled_batches`` match the
JAX stacks field for field. Dropout is tested as "runs and learns".
"""

import numpy as np
import pytest
import torch

from torch_world import (
    GRAPH_FIELDS,
    graph_arrays,
    graph_from_arrays,
    grads_numpy,
    hold_shares,
    numpy_tree,
    rank_inputs,
    run_world,
    summed_shares,
    write_rank_results,
)

pytestmark = pytest.mark.multichip

N_NODES, N_FEAT, HID, N_CLASS, BATCH = 2000, 8, 16, 5, 24
FANOUTS = (4, 3)
PADS = dict(n_node_pad=1024, n_edge_pad=2048)
AGGS = ("mean", "mean2")
DROPOUT_STEPS = 5
WORLDS = (2, 4)


def _data():
    """The host graph, features, labels and ``(8, BATCH)`` seed rows."""
    rs = np.random.RandomState(4)
    src = rs.randint(0, N_NODES, 16000).astype(np.int32)
    dst = rs.randint(0, N_NODES, 16000).astype(np.int32)
    keep = src != dst
    src, dst = np.concatenate([src[keep], dst[keep]]), np.concatenate([dst[keep], src[keep]])
    feats = rs.randn(N_NODES, N_FEAT).astype(np.float32)
    labels = rs.randint(0, N_CLASS, N_NODES)
    seeds = rs.randint(0, N_NODES, size=(8, BATCH))
    return src, dst, feats, labels, seeds


def _port_pieces(w, keep_structure):
    """The port's per-rank ``(x, graph, y, seed_mask)`` for the first ``w``
    seed rows, sampled one row after the other by one sampler."""
    from mma_tpu_torch.data.sampling import NeighborSampler
    from mma_tpu_torch.train.sampled import stack_sampled_batches

    src, dst, feats, labels, seeds = _data()
    sampler = NeighborSampler.from_host_arrays(src, dst, N_NODES, FANOUTS, seed=9, device="cpu")
    batches = [sampler.sample(s, device="cpu", **PADS) for s in seeds[:w]]
    return stack_sampled_batches(batches, feats, labels, keep_structure)


# ------------------------------------------------------------------ ranks

def sampled_worker(workdir):
    """One rank: the DP step on this rank's piece, with and without the
    kernel structure; dropout steps; the producer and the command line in
    data-parallel mode."""
    import torch.distributed as dist

    from mma_tpu_torch.cli import train_sampled as cli
    from mma_tpu_torch.convert import node_classifier_from_jax
    from mma_tpu_torch.data.sampling import NeighborSampler
    from mma_tpu_torch.models import NodeClassifier
    from mma_tpu_torch.parallel import initialize_distributed, make_mesh
    from mma_tpu_torch.train import make_optimizer
    from mma_tpu_torch.train.sampled import (
        DeviceTableAssembler,
        make_sampled_dp_step,
        sampled_batch_producer,
    )

    initialize_distributed("cpu")
    # Replicated results are compared bitwise across the ranks.
    torch.use_deterministic_algorithms(True)
    inp = rank_inputs(workdir)
    mesh = make_mesh(("data",))
    rank, w = dist.get_rank(), dist.get_world_size()

    def model(dropout):
        m = NodeClassifier(N_FEAT, HID, N_CLASS, AGGS, dropout_rate=dropout, device="cpu")
        return node_classifier_from_jax(inp["params"], m)

    res = {}
    for ks in (False, True):
        x, graph, y, sm = inp[f"pieces_{ks}"][rank]
        graph = graph_from_arrays(graph)
        net = model(0.0)
        opt = torch.optim.SGD(net.parameters(), lr=0.0)  # keeps the summed gradients
        res[f"loss_{ks}"] = float(make_sampled_dp_step(net, opt, mesh)(
            torch.from_numpy(x), graph, torch.from_numpy(y), torch.from_numpy(sm)))
        res[f"grads_{ks}"] = grads_numpy(net)

    x, graph, y, sm = inp["pieces_True"][rank]
    net = model(0.5)
    opt = make_optimizer(net.parameters(), 0.01)
    step = make_sampled_dp_step(net, opt, mesh)
    gen = torch.Generator().manual_seed(1 + rank)
    args = (torch.from_numpy(x), graph_from_arrays(graph), torch.from_numpy(y),
            torch.from_numpy(sm))
    res["dropout_losses"] = [float(step(*args, gen)) for _ in range(DROPOUT_STEPS)]

    # The producer on (w, BATCH) seed batches: this rank's row.
    src, dst, feats, labels, seeds = _data()
    sampler = NeighborSampler.from_host_arrays(src, dst, N_NODES, FANOUTS, seed=9, device="cpu")
    (px, pg, py, psm), = sampled_batch_producer(
        sampler, iter([seeds[:w]]), DeviceTableAssembler(feats, labels, device="cpu"),
        rank=rank, **PADS)
    res["produced"] = (px.numpy(), graph_arrays(pg), py.numpy(), psm.numpy())
    # The command line's data-parallel mode in this world.
    out = cli.main(["--device", "cpu", "--nodes", "3000", "--batch-size", "32", "--steps", "3",
                    "--n-feat", "8"])
    res["cli_losses"] = out["losses"]
    write_rank_results(workdir, res)


# ------------------------------------------------------------- JAX side

def _jax_side(w):
    import jax
    import jax.numpy as jnp
    import optax
    from mma_tpu.data.sampling import NeighborSampler
    from mma_tpu.models import NodeClassifier
    from mma_tpu.parallel import make_mesh
    from mma_tpu.train.sampled import make_sampled_dp_step, stack_sampled_batches

    src, dst, feats, labels, seeds = _data()
    sampler = NeighborSampler.from_host_arrays(src, dst, N_NODES, FANOUTS, seed=9)
    batches = [sampler.sample(s, **PADS) for s in seeds[:w]]
    model = NodeClassifier(n_feat=N_FEAT, n_hidden=HID, n_class=N_CLASS, aggregators=AGGS,
                           dropout_rate=0.0)
    params = model.init(jax.random.PRNGKey(0))
    mesh = make_mesh(("data",), devices=jax.devices()[:w])
    keep = optax.GradientTransformation(  # its state after a step holds the gradients
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, _, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    out = {"params": numpy_tree(params)}
    for ks in (False, True):
        x, g, y, sm = stack_sampled_batches(batches, feats, labels, keep_structure=ks)
        out[f"stack_{ks}"] = (np.asarray(x), graph_arrays(g), np.asarray(y), np.asarray(sm),
                              g.ell_hint)
        step = make_sampled_dp_step(model, keep, mesh, "data")
        _, grads, loss = step(params, keep.init(params), x, g, y, sm,
                              jax.random.split(jax.random.PRNGKey(1), w))
        out[f"loss_{ks}"], out[f"grads_{ks}"] = float(loss), numpy_tree(grads)
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=[f"W{w}" for w in WORLDS])
def world(request, tmp_path_factory):
    w = request.param
    want = _jax_side(w)
    inputs = {"params": want["params"]}
    for ks in (False, True):
        inputs[f"pieces_{ks}"] = [(x.numpy(), graph_arrays(g), y.numpy(), sm.numpy())
                                  for x, g, y, sm in _port_pieces(w, ks)]
    ranks = run_world("test_torch_sampled_dp:sampled_worker", w, inputs,
                      str(tmp_path_factory.mktemp(f"sampled_world{w}")))
    return w, ranks, want


# ----------------------------------------------------------------- tests

def _flat(tree):
    return {f"{k}.{n}": v for k, sub in tree.items() for n, v in sub.items()}


@pytest.mark.parametrize("ks", [False, True], ids=["stripped", "kernel_structure"])
def test_stacks_match_jax(world, ks):
    """``stack_sampled_batches`` (through ``stack_graphs``) gives piece r =
    row r of the JAX package's stacks, field for field: features, labels,
    seed mask and every graph field (no CSC when stripped)."""
    w, _, want = world
    jx, jg, jy, jsm, hint = want[f"stack_{ks}"]
    for r, (x, g, y, sm) in enumerate(_port_pieces(w, ks)):
        np.testing.assert_array_equal(x.numpy(), jx[r])
        np.testing.assert_array_equal(y.numpy(), jy[r])
        assert y.dtype == torch.int64
        np.testing.assert_array_equal(sm.numpy(), jsm[r])
        assert g.ell_hint == hint
        for f in GRAPH_FIELDS:
            if jg[f] is None:
                assert getattr(g, f) is None, f
            else:
                np.testing.assert_array_equal(getattr(g, f).numpy(), jg[f][r], err_msg=f)


@pytest.mark.parametrize("ks", [False, True], ids=["half_fused", "lean"])
def test_sampled_dp_step_matches_jax(world, ks):
    """One DP step (dropout off) on every rank: the global seed-weighted
    NLL and the summed gradients of the JAX ``make_sampled_dp_step`` on a
    mesh of the same size, bitwise equal across the ranks."""
    _, ranks, want = world
    for res in ranks:
        assert res[f"loss_{ks}"] == pytest.approx(want[f"loss_{ks}"], rel=1e-5)
        for name, v in res[f"grads_{ks}"].items():
            np.testing.assert_array_equal(v, ranks[0][f"grads_{ks}"][name])
    for name, v in _flat(want[f"grads_{ks}"]).items():
        np.testing.assert_allclose(ranks[0][f"grads_{ks}"][name], v, rtol=2e-4, atol=1e-5,
                                   err_msg=name)


def test_sampled_dp_gradients_sum_the_ranks_shares(world):
    """The summed gradients equal the ranks' shares (seed NLL sum over the
    global seed count) computed one after the other in this process."""
    from mma_tpu_torch.convert import node_classifier_from_jax
    from mma_tpu_torch.models import NodeClassifier

    w, ranks, want = world
    net = node_classifier_from_jax(
        want["params"], NodeClassifier(N_FEAT, HID, N_CLASS, AGGS, dropout_rate=0.0,
                                       device="cpu"))

    def nll_sum(m, piece):
        x, g, y, sm = piece
        logp = m(x, g, training=True)
        return (-logp[torch.arange(y.shape[0]), y] * sm).sum(), sm.sum()

    hold_shares(ranks[0]["grads_True"], summed_shares(net, _port_pieces(w, True), nll_sum))


def test_sampled_dp_step_with_dropout_learns(world):
    """Dropout 0.5 drawn from a generator per rank: the ranks stay in step
    and the global loss falls over 5 steps on the same subgraphs."""
    _, ranks, _ = world
    losses = ranks[0]["dropout_losses"]
    for res in ranks[1:]:
        assert res["dropout_losses"] == losses
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_producer_serves_each_rank_its_row(world):
    """``sampled_batch_producer(rank=r)`` on ``(W, batch)`` seed batches
    yields the subgraph of row r, as the port's piece r (sampled one row
    after the other) holds it for rank 0 and as a fresh sampler samples row
    r alone for every rank."""
    from mma_tpu_torch.data.sampling import NeighborSampler
    from mma_tpu_torch.train.sampled import prepare_sampled_arrays

    w, ranks, _ = world
    src, dst, feats, labels, seeds = _data()
    for r, res in enumerate(ranks):
        sampler = NeighborSampler.from_host_arrays(src, dst, N_NODES, FANOUTS, seed=9,
                                                   device="cpu")
        b = sampler.sample(seeds[r], device="cpu", **PADS)
        x, g, y, sm = res["produced"]
        wx, wy, wsm = prepare_sampled_arrays(b, feats, labels)
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)
        np.testing.assert_array_equal(sm, wsm)
        for f in GRAPH_FIELDS:
            np.testing.assert_array_equal(g[f], getattr(b.graph, f).numpy(), err_msg=f)


def test_cli_data_parallel_mode_runs(world):
    """The command line in the world (``WORLD_SIZE`` set, as ``torchrun``
    sets it) trains in data-parallel mode: every rank reports the same
    global losses, finite."""
    _, ranks, _ = world
    losses = ranks[0]["cli_losses"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    for res in ranks[1:]:
        assert res["cli_losses"] == losses
