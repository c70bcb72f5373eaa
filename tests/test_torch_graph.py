"""The port's graph builders and loaders against the JAX package's, field
for field, on the CPU."""

import numpy as np
import pytest
import torch

from mma_tpu.data import load_planetoid as jax_load_planetoid
from mma_tpu.graph.build import graph_from_edges as jax_graph_from_edges

from mma_tpu_torch.data import load_planetoid, powerlaw_edges, synthetic_powerlaw
from mma_tpu_torch.graph import graph_from_edges

ARRAY_FIELDS = (
    "src", "dst", "edge_mask", "node_mask", "deg", "row_ptr",
    "src_perm", "col_ptr", "src_csc", "dst_csc",
)


def assert_same_graph(got, want):
    assert got.n_node == want.n_node and got.n_edge == want.n_edge
    for name in ARRAY_FIELDS:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert int(got.num_nodes) == int(want.num_nodes)
    assert int(got.num_edges) == int(want.num_edges)


def test_graph_from_edges_matches_jax_with_duplicates_and_isolated_nodes():
    rs = np.random.RandomState(0)
    n = 300
    # Nodes 250..299 stay isolated; repeated pairs make duplicate edges.
    src = rs.randint(0, 250, 1500).astype(np.int32)
    dst = rs.randint(0, 250, 1500).astype(np.int32)
    src = np.concatenate([src, src[:200]])
    dst = np.concatenate([dst, dst[:200]])
    got = graph_from_edges(src, dst, n, device="cpu")
    want = jax_graph_from_edges(src, dst, n)
    assert_same_graph(got, want)
    assert got.deg[250:n].sum() == 0


def test_graph_from_edges_explicit_padding_matches_jax():
    rs = np.random.RandomState(1)
    src = rs.randint(0, 40, 90).astype(np.int32)
    dst = rs.randint(0, 40, 90).astype(np.int32)
    got = graph_from_edges(src, dst, 40, n_node_pad=64, n_edge_pad=2048, device="cpu")
    want = jax_graph_from_edges(src, dst, 40, n_node_pad=64, n_edge_pad=2048)
    assert_same_graph(got, want)


@pytest.mark.parametrize("name", ["cora", "citeseer"])
def test_load_planetoid_matches_jax(name):
    got = load_planetoid(name, device="cpu")
    want = jax_load_planetoid(name)
    assert_same_graph(got.graph, want.graph)
    for field in ("features", "labels", "idx_train", "idx_val", "idx_test"):
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert (got.num_nodes, got.num_classes) == (want.num_nodes, want.num_classes)


def test_synthetic_powerlaw_matches_graph_from_edges():
    import bench

    got = synthetic_powerlaw(4096, avg_deg=16, seed=1, device="cpu")
    want = bench.powerlaw_graph(4096, 16, seed=1)
    assert_same_graph(got, want)
    src, dst = powerlaw_edges(4096, 16, seed=1)
    assert_same_graph(graph_from_edges(src, dst, 4096, device="cpu"), want)


def test_graph_to_moves_every_tensor():
    g = graph_from_edges(np.array([0, 1], np.int32), np.array([1, 0], np.int32), 2,
                         device="cpu")
    moved = g.to("cpu")
    assert moved.row_ptr.device == torch.device("cpu")
    assert moved.n_node == g.n_node and moved.ell_hint is None


def test_default_device_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid here")
    src = np.array([0, 1], np.int32)
    dst = np.array([1, 0], np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graph_from_edges(src, dst, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_planetoid("cora")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_powerlaw(64, avg_deg=4)
