"""The port's counterpart of ``test_misc_parity.py`` and of the Planetoid
cases of ``test_data_readiness.py``, on the CPU.

N2 (always-on eval mask dropout), N5 (aggregators that crash in the
reference, gated by ``parity``), N8 (suffixed aggregators refused by graph
regression), an unknown aggregator, determinism, ``BatchNorm`` against
``torch.nn.BatchNorm1d``; and ``load_planetoid`` on a miniature Planetoid
file set: the real ``allx`` path (against the JAX loader too) and the
refusal without ``synthetic_features``.
"""

import os
import pickle

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from mma_tpu.data import load_planetoid as jax_load_planetoid
from mma_tpu.nn.mma_layer import MMALayer as JaxMMALayer

from mma_tpu_torch.data import load_planetoid
from mma_tpu_torch.graph import graph_from_dense
from mma_tpu_torch.models import NodeClassifier
from mma_tpu_torch.nn import BatchNorm, MMALayer, MultiMaskConv
from mma_tpu_torch.ops import get_agg_spec, masked_multi_aggregate

from helpers import random_symmetric_graph

N, F = 30, 8


@pytest.fixture(scope="module")
def setup():
    a, _, jgraph = random_symmetric_graph(N, p=0.2, seed=9)
    graph = graph_from_dense(a, device="cpu")
    rs = np.random.RandomState(1)
    x = np.zeros((graph.n_node, 6), np.float32)
    x[:N] = rs.randn(N, 6)
    return graph, torch.from_numpy(x), jgraph


def test_n2_eval_dropout_parity(setup):
    """The reference's eval keeps mask dropout on (N2): with
    ``parity_eval_dropout`` the eval forward differs across generators;
    without it, eval is deterministic and ignores the generator."""
    graph, x, _ = setup
    model = NodeClassifier(6, F, 3, ("mean",), dropout_rate=0.5, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        o1, o2 = (model(x, graph, generator=torch.Generator().manual_seed(s),
                        parity_eval_dropout=True) for s in (1, 2))
        assert not torch.allclose(o1[:N], o2[:N])
        d1 = model(x, graph)
        d2 = model(x, graph, generator=torch.Generator().manual_seed(1))
    assert torch.equal(d1, d2)


@pytest.mark.parametrize("name", ["std", "normalized_mean", "moment_3"])
def test_n5_broken_aggregators_gated_by_parity(setup, name):
    """Refused with ``parity=True``; with ``parity=False`` the intended
    semantics, finite and equal to the JAX layer's with its weights."""
    graph, x, jgraph = setup
    with pytest.raises(ValueError, match="unusable in the reference"):
        MMALayer(F, 3, (name,), parity=True, device="cpu")
    layer = MMALayer(6, 3, (name,), parity=False, device="cpu")
    jlayer = JaxMMALayer(in_features=6, out_features=3, aggregators=(name,), parity=False)
    params = jlayer.init(jax.random.PRNGKey(0))
    with torch.no_grad():
        for p in ("w", "masks", "b"):
            getattr(layer, p).copy_(torch.tensor(np.asarray(params[p], np.float32)))
        got = layer(x, graph)[:N]
    want = np.asarray(jlayer.apply(params, jnp.asarray(x.numpy()), jgraph))[:N]
    assert torch.isfinite(got).all(), name
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                               err_msg=name)


def test_n8_suffixed_aggregators_raise_in_graph_regression():
    with pytest.raises(ValueError, match="Unknown aggregator"):
        MultiMaskConv(8, 8, ("min2",), ("identity",), avg_deg={"lin": 1.0, "log": 1.0},
                      device="cpu")


def test_unknown_aggregator_raises():
    with pytest.raises(ValueError, match="Unknown aggregator"):
        get_agg_spec("median")


def test_aggregation_deterministic(setup):
    """Same inputs, bitwise-identical outputs."""
    graph, _, _ = setup
    rs = np.random.RandomState(3)
    h = torch.from_numpy(rs.randn(graph.n_node, F).astype(np.float32))
    w = torch.from_numpy(rs.randn(1, 2 * F, F).astype(np.float32))
    spec = (get_agg_spec("sum"),)
    assert torch.equal(masked_multi_aggregate(h, graph, w, spec),
                       masked_multi_aggregate(h, graph, w, spec))


def test_batchnorm_matches_torch():
    """``BatchNorm`` (training, the running statistics, eval) against
    ``torch.nn.BatchNorm1d``."""
    rs = np.random.RandomState(0)
    bn = BatchNorm(5, device="cpu")
    tbn = torch.nn.BatchNorm1d(5)
    for _ in range(3):
        x = torch.from_numpy(rs.randn(16, 5).astype(np.float32))
        tbn.train()
        torch.testing.assert_close(bn(x, training=True), tbn(x), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(bn.mean, tbn.running_mean, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(bn.var, tbn.running_var, rtol=1e-4, atol=1e-5)
    x = torch.from_numpy(rs.randn(16, 5).astype(np.float32))
    tbn.eval()
    with torch.no_grad():
        torch.testing.assert_close(bn(x, training=False), tbn(x), rtol=1e-4, atol=1e-5)


# ---- Planetoid: the real allx path ------------------------------------


def _write_mini_planetoid(root, name="pubmed", seed=3):
    """A complete miniature Planetoid file set: 12 nodes, 8 in allx, 4 test
    nodes with a shuffled test.index (x ⊂ allx, tx rows in test.index
    order)."""
    rs = np.random.RandomState(seed)
    n, n_test, f, c = 12, 4, 5, 3
    n_all = n - n_test
    allx_d = (rs.rand(n_all, f) < 0.5).astype(np.float32)
    tx_d = (rs.rand(n_test, f) < 0.5).astype(np.float32)
    ally = np.eye(c)[rs.randint(c, size=n_all)]
    ty = np.eye(c)[rs.randint(c, size=n_test)]
    n_y = 3
    test_reorder = np.array([10, 8, 11, 9])
    graph_dict = {i: [] for i in range(n)}
    for a, b in [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 7),
                 (7, 8), (8, 9), (9, 10), (10, 11), (11, 0), (2, 9)]:
        graph_dict[a].append(b)
    objs = {
        "x": sp.csr_matrix(allx_d[:n_y]),
        "y": ally[:n_y],
        "tx": sp.csr_matrix(tx_d),
        "ty": ty,
        "allx": sp.csr_matrix(allx_d),
        "ally": ally,
        "graph": graph_dict,
    }
    for part, obj in objs.items():
        with open(os.path.join(root, f"ind.{name}.{part}"), "wb") as fh:
            pickle.dump(obj, fh)
    with open(os.path.join(root, f"ind.{name}.test.index"), "w") as fh:
        fh.write("\n".join(str(i) for i in test_reorder) + "\n")
    return allx_d, tx_d, ally, ty, test_reorder


def test_planetoid_real_allx_path(tmp_path):
    allx_d, tx_d, ally, ty, test_reorder = _write_mini_planetoid(str(tmp_path))
    data = load_planetoid("pubmed", root=str(tmp_path), device="cpu")

    assert data.num_nodes == 12
    features, labels = data.features.numpy(), data.labels.numpy()
    np.testing.assert_array_equal(features[:8], allx_d)  # allx rows on nodes 0..7
    for k, node in enumerate(test_reorder):  # tx[k] belongs to node test.index[k]
        np.testing.assert_array_equal(features[node], tx_d[k])
        assert labels[node] == ty[k].argmax()
    np.testing.assert_array_equal(labels[:8], ally.argmax(1))
    np.testing.assert_array_equal(data.idx_test.numpy(), np.sort(test_reorder))
    g = data.graph  # symmetric, unnormalised: every edge has its reverse
    e = int(g.num_edges)
    pairs = set(zip(g.src[:e].tolist(), g.dst[:e].tolist()))
    assert all((d, s) in pairs for s, d in pairs)
    assert len(pairs) == 13 * 2

    want = jax_load_planetoid("pubmed", root=str(tmp_path))
    for field in ("features", "labels", "idx_train", "idx_val", "idx_test"):
        np.testing.assert_array_equal(getattr(data, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    for field in ("src", "dst", "row_ptr", "col_ptr", "src_perm", "deg"):
        np.testing.assert_array_equal(getattr(g, field).numpy(),
                                      np.asarray(getattr(want.graph, field)), err_msg=field)


def test_planetoid_missing_allx_requires_flag(tmp_path):
    """Without allx the loader refuses unless ``synthetic_features=True``:
    a quality run can never use made-up features unawares."""
    _write_mini_planetoid(str(tmp_path))
    os.remove(os.path.join(str(tmp_path), "ind.pubmed.allx"))
    with pytest.raises(FileNotFoundError, match="synthetic_features"):
        load_planetoid("pubmed", root=str(tmp_path), device="cpu")
    data = load_planetoid("pubmed", root=str(tmp_path), synthetic_features=True, device="cpu")
    assert data.num_nodes == 12
