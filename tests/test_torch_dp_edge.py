"""The port's 2-D (data × edge) regime and its cross-shard min/max against
the JAX package, on a gloo world of 4 CPU processes.

The world runs once (:func:`world`): a ``("data", "edge")`` mesh of 2 × 2,
every rank running :func:`dp_edge_worker` over all the cases. The JAX
package runs the same regimes in this process on meshes of the same shapes
from the first 4 of the 8 forced host devices, on its XLA path. The ranks
import this module, so JAX and ``mma_tpu`` are imported only inside the
functions that compute the JAX side.

Mirrors ``tests/test_dp_edge.py:45-199`` with its tolerances: the forward
within rtol = atol = 1e-5; the train step (smooth aggregators, dropout
off) within 1e-5 on the loss, gradients within rtol 2e-4 and atol 1e-5
(``torch_world.hold_zinc_grads``), parameters by
``torch_world.hold_adam_params`` and BatchNorm buffers within rtol 1e-4,
atol 1e-5; the cross-shard min/max VJP on continuous data within rtol
1e-6, atol 1e-7, on edge axes of 2 (the 2 × 2 mesh's) and 4 ranks.
Dropout is tested as "runs and learns".
"""

import numpy as np
import pytest
import torch

from torch_world import (
    graph_arrays,
    graph_from_arrays,
    grads_numpy,
    hold_adam_params,
    hold_zinc_grads,
    numpy_tree,
    params_numpy,
    rank_inputs,
    run_world,
    write_rank_results,
)

pytestmark = pytest.mark.multichip

D, E_SHARDS = 2, 2
SCALERS = ("identity", "amplification", "linear")
FWD_AGGS, STEP_AGGS = ("min", "max", "mean", "sum"), ("mean", "sum")
NET_KW = dict(towers=3, num_layers=2)
PAD = dict(n_node=120, n_edge=260)
DROPOUT_STEPS = 6
VJP_EDGE_SIZES = (2, 4)
VJP_C = 6


# ------------------------------------------------------------------ ranks

def dp_edge_worker(workdir):
    """One rank of the 2 × 2 world: every case of this module."""
    import torch.distributed as dist

    from mma_tpu_torch.convert import zinc_net_from_jax
    from mma_tpu_torch.data import load_zinc
    from mma_tpu_torch.models import ZincNet
    from mma_tpu_torch.nn.mma_conv import MultiMaskConv
    from mma_tpu_torch.parallel import (
        initialize_distributed,
        localize_graph,
        make_dp_edge_forward,
        make_dp_edge_train_step,
        make_mesh,
        pad_edges_for_sharding,
        shard_batches_dp_edge,
    )
    from mma_tpu_torch.train import make_optimizer

    initialize_distributed("cpu")
    # Replicated results are compared bitwise across the ranks.
    torch.use_deterministic_algorithms(True)
    inp = rank_inputs(workdir)
    mesh = make_mesh(("data", "edge"), shape=(D, E_SHARDS))
    it = load_zinc("val", subset_size=16).batches(4, device="cpu", **PAD)
    batch = shard_batches_dp_edge([next(it) for _ in range(D)], mesh, device="cpu")

    def net(aggs, key):
        m = ZincNet(aggs, SCALERS, inp["avg"], device="cpu", **NET_KW)
        return zinc_net_from_jax(inp[key], inp["state"], m)

    res = {"graph": graph_arrays(batch.graph)}
    with torch.no_grad():
        res["pred"] = make_dp_edge_forward(net(FWD_AGGS, "fwd_params"), mesh)(batch).numpy()
    model = net(STEP_AGGS, "step_params")
    opt = make_optimizer(model.parameters(), 1e-3, 3e-4)
    res["loss"] = float(make_dp_edge_train_step(model, opt, mesh)(batch))
    res["grads"], res["params"] = grads_numpy(model), params_numpy(model)
    res["buffers"] = {n: b.numpy().copy() for n, b in model.named_buffers()}

    model = net(FWD_AGGS, "fwd_params")
    opt = make_optimizer(model.parameters(), 5e-3, 0.0)
    step = make_dp_edge_train_step(model, opt, mesh)
    d = mesh.get_local_rank("data")
    res["dropout_losses"] = [float(step(batch, seed=i * D + d)) for i in range(DROPOUT_STEPS)]

    # The cross-shard min/max reduce: over the 2 × 2 mesh's edge axis, then a
    # 1-D mesh of all 4 ranks.
    conv = MultiMaskConv(VJP_C, VJP_C, ("min",), ("identity",), {"lin": 2.0, "log": 1.0},
                         towers=1, device="cpu")
    for size in VJP_EDGE_SIZES:
        group = (mesh.get_group("edge") if size == E_SHARDS
                 else make_mesh(("edge",), shape=(size,)).get_group("edge"))
        v = inp["vjp"][size]
        graph = pad_edges_for_sharding(graph_from_arrays(v["graph"]), size)
        shard = dist.get_rank(group)
        local = localize_graph(graph, size, shard)
        e_loc = graph.n_edge // size
        deg = torch.clamp(graph.deg, min=1.0)[:, None]
        ct = torch.from_numpy(v["ct"])
        for name in ("min", "max"):
            m = torch.from_numpy(v["msgs"][shard * e_loc:(shard + 1) * e_loc]).requires_grad_()
            out = conv._reduce(name, m, local, deg, axis_name=group)
            ((out * ct).sum() / size).backward()
            res[f"vjp_{size}_{name}"] = (out.detach().numpy(), shard, m.grad.numpy().copy())
    write_rank_results(workdir, res)


# ------------------------------------------------------------- JAX side

def _jax_side():
    import dataclasses
    import functools

    import jax
    import jax.numpy as jnp
    import optax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from helpers import random_symmetric_graph
    from mma_tpu.data import load_zinc
    from mma_tpu.models import ZincNet
    from mma_tpu.nn.mma_conv import MultiMaskConv, compute_avg_deg
    from mma_tpu.parallel import (
        make_dp_edge_forward,
        make_dp_edge_train_step,
        make_mesh,
        pad_edges_for_sharding,
        shard_batches_dp_edge,
    )
    from mma_tpu.train import make_optimizer

    ds = load_zinc("val", subset_size=16)
    avg = compute_avg_deg(jnp.asarray(ds.degree_histogram()), parity=True)
    it = ds.batches(4, **PAD)
    batches = [next(it) for _ in range(D)]
    mesh = make_mesh(("data", "edge"), shape=(D, E_SHARDS), devices=jax.devices()[:D * E_SHARDS])
    stacked = shard_batches_dp_edge(batches, mesh)
    fnet = ZincNet(aggregators=FWD_AGGS, scalers=SCALERS, avg_deg=tuple(avg.items()), **NET_KW)
    snet = ZincNet(aggregators=STEP_AGGS, scalers=SCALERS, avg_deg=tuple(avg.items()), **NET_KW)
    fparams, sparams = fnet.init(jax.random.PRNGKey(0)), snet.init(jax.random.PRNGKey(0))
    state = fnet.init_state()
    out = dict(avg={k: float(v) for k, v in avg.items()}, fwd_params=numpy_tree(fparams),
               step_params=numpy_tree(sparams), state=numpy_tree(state),
               stacked_graph=graph_arrays(stacked.graph))
    out["pred"] = np.asarray(make_dp_edge_forward(fnet, mesh)(fparams, state, stacked))

    adam = make_optimizer(learning_rate=1e-3, weight_decay=3e-4)
    opt = optax.GradientTransformation(  # Adam, keeping the gradients in its state
        lambda p: (adam.init(p), jax.tree.map(jnp.zeros_like, p)),
        lambda g, st, p=None: (lambda u, a: (u, (a, g)))(*adam.update(g, st[0], p)))
    p2, s2, o2, loss = make_dp_edge_train_step(snet, opt, mesh)(
        sparams, state, opt.init(sparams), stacked, None)
    out.update(loss=float(loss), params=numpy_tree(p2), grads=numpy_tree(o2[1]),
               state2=numpy_tree(s2))

    # The cross-shard min/max VJP (tests/test_dp_edge.py:154-199), per size.
    conv = MultiMaskConv(in_channels=VJP_C, out_channels=VJP_C, aggregators=("min",),
                         scalers=("identity",), avg_deg=(("lin", 2.0), ("log", 1.0)), towers=1)
    _, _, graph = random_symmetric_graph(24, p=0.2, seed=3)
    out["vjp"], out["vjp_inputs"] = {}, {}
    for size in VJP_EDGE_SIZES:
        g = pad_edges_for_sharding(graph, size)
        rs = np.random.RandomState(size)
        msgs = rs.randn(g.n_edge, VJP_C).astype(np.float32)
        ct = rs.randn(g.n_node, VJP_C).astype(np.float32)
        out["vjp_inputs"][size] = dict(graph=graph_arrays(graph), msgs=msgs, ct=ct)
        deg = jnp.maximum(g.deg, 1.0)[:, None]
        vmesh = make_mesh(("edge",), shape=(size,), devices=jax.devices()[:size])
        espec = dataclasses.replace(
            jax.tree.map(lambda _: P(), g), src=P("edge"), dst=P("edge"), edge_mask=P("edge"),
            src_perm=None, col_ptr=None, src_csc=None, dst_csc=None, chunk_hint=None)
        g_s = dataclasses.replace(g, src_perm=None, col_ptr=None, src_csc=None, dst_csc=None,
                                  chunk_hint=None)
        for name in ("min", "max"):
            red = shard_map(
                functools.partial(lambda nm, m, gg: conv._reduce(nm, m, gg, deg, axis_name="edge"),
                                  name),
                mesh=vmesh, in_specs=(P("edge"), espec), out_specs=P(), check_rep=False)
            (_, v), gr = jax.jit(jax.value_and_grad(
                lambda m: (lambda o: (jnp.sum(o * jnp.asarray(ct)), o))(red(m, g_s)),
                has_aux=True))(jnp.asarray(msgs))
            out["vjp"][(size, name)] = (np.asarray(v), np.asarray(gr))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    want = _jax_side()
    inputs = dict(avg=want["avg"], fwd_params=want["fwd_params"],
                  step_params=want["step_params"], state=want["state"],
                  vjp=want["vjp_inputs"])
    ranks = run_world("test_torch_dp_edge:dp_edge_worker", D * E_SHARDS, inputs,
                      str(tmp_path_factory.mktemp("dp_edge_world")))
    return ranks, want


# ----------------------------------------------------------------- tests

def _group_ranks(ranks):
    """The ranks of each data group, mesh order (data-major)."""
    return [ranks[d * E_SHARDS:(d + 1) * E_SHARDS] for d in range(D)]


def test_dp_edge_shards_match_jax(world):
    """Rank (d, e) holds the JAX package's edge shard e of micro-batch d
    (``shard_batches_dp_edge``): the edge arrays field for field, the node
    arrays whole, no CSC."""
    ranks, want = world
    sg = want["stacked_graph"]
    for d, group in enumerate(_group_ranks(ranks)):
        for e, res in enumerate(group):
            g = res["graph"]
            e_loc = sg["src"].shape[1] // E_SHARDS
            for f in ("src", "dst", "edge_mask"):
                np.testing.assert_array_equal(g[f], sg[f][d, e * e_loc:(e + 1) * e_loc], f)
            for f in ("node_mask", "deg"):
                np.testing.assert_array_equal(g[f], sg[f][d], f)
            assert g["src_perm"] is None and g["dst_csc"] is None


def test_dp_edge_forward_matches_jax(world):
    """Every rank of data group d predicts the JAX 2-D forward's row d
    (``tests/test_dp_edge.py:45-54``), bitwise equal within the group."""
    ranks, want = world
    for d, group in enumerate(_group_ranks(ranks)):
        for res in group[1:]:
            np.testing.assert_array_equal(res["pred"], group[0]["pred"])
        np.testing.assert_allclose(group[0]["pred"], want["pred"][d], rtol=1e-5, atol=1e-5)


def test_dp_edge_train_step_matches_jax(world):
    """One 2-D step of the smooth aggregators (``mean,sum``, dropout off):
    the JAX step's loss, summed gradients, updated parameters and
    data-averaged BatchNorm state (``tests/test_dp_edge.py:57-124``), the
    same on every rank."""
    from mma_tpu_torch.convert import zinc_net_from_jax
    from mma_tpu_torch.models import ZincNet

    ranks, want = world
    for res in ranks:
        assert res["loss"] == pytest.approx(want["loss"], rel=1e-5)
        for key in ("grads", "params", "buffers"):
            for name, v in res[key].items():
                np.testing.assert_array_equal(v, ranks[0][key][name], err_msg=f"{key} {name}")
    ref = ZincNet(STEP_AGGS, SCALERS, want["avg"], device="cpu", **NET_KW)

    def port_names(params_tree, state_tree):
        zinc_net_from_jax(params_tree, state_tree, ref)
        return ({n: p.detach().numpy().copy() for n, p in ref.named_parameters()},
                {n: b.numpy().copy() for n, b in ref.named_buffers()})

    grads, _ = port_names(want["grads"], want["state2"])
    params, state = port_names(want["params"], want["state2"])
    hold_zinc_grads(ranks[0]["grads"], grads)
    hold_adam_params(ranks[0]["params"], params, grads, 1e-3, 1)
    for name, b in state.items():
        np.testing.assert_allclose(ranks[0]["buffers"][name], b, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_dp_edge_step_with_dropout_learns(world):
    """Message dropout with a seed per data group, folded with the edge
    index on each shard: the loss falls over 6 steps
    (``tests/test_dp_edge.py:127-141``), the same on every rank."""
    ranks, _ = world
    losses = ranks[0]["dropout_losses"]
    for res in ranks[1:]:
        assert res["dropout_losses"] == losses
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


@pytest.mark.parametrize("size", VJP_EDGE_SIZES)
@pytest.mark.parametrize("name", ["min", "max"])
def test_cross_shard_minmax_vjp_matches_jax(world, name, size):
    """The ``all_gather`` + ``amax``/``amin`` reduce across edge shards:
    its output on every rank and each shard's slice of the input cotangent
    equal the JAX package's cross-shard reduce on continuous messages
    (``tests/test_dp_edge.py:144-199``, which holds the scalar ``Σ out·ct``
    at rtol 1e-6: here each element of ``out``, since the scalar's f32 sum
    order differs between the packages)."""
    ranks, want = world
    v_want, g_want = want["vjp"][(size, name)]
    got = {}
    for res in ranks:
        v, shard, g = res[f"vjp_{size}_{name}"]
        np.testing.assert_allclose(v, v_want, rtol=1e-6, atol=1e-7)
        got.setdefault(shard, g)
    grad = np.concatenate([got[s] for s in range(size)])
    np.testing.assert_allclose(grad, g_want, rtol=1e-6, atol=1e-7)
