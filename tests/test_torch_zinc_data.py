"""The port's ZINC data layer against the JAX package's, on the CPU: the
synthetic splits, the npz loader, the plain collate field for field, the
degree histogram and the scalers' degree statistics. Exact equality
everywhere except ``compute_avg_deg`` (float32 means taken in another
summation order: 1e-6 relative)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mma_tpu.data import load_zinc as jax_load_zinc
from mma_tpu.nn.mma_conv import compute_avg_deg as jax_compute_avg_deg

from mma_tpu_torch.data import batch_graphs, load_zinc
from mma_tpu_torch.data.batching import degree_budgets
from mma_tpu_torch.nn.mma_conv import compute_avg_deg
from mma_tpu_torch.ops import segment_sum
from mma_tpu_torch.ops.cuda.fused_mma import segment_sum_csr

_GRAPH_FIELDS = ("src", "dst", "edge_mask", "node_mask", "deg", "row_ptr", "src_perm",
                 "col_ptr", "src_csc", "dst_csc")
_BATCH_FIELDS = ("node_to_graph", "graph_mask", "node_feat", "edge_feat", "target")


def _equal(a, b, what):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=what)


def _same_dataset(jd, td):
    assert jd.synthetic == td.synthetic and len(jd) == len(td)
    _equal(jd.num_nodes, td.num_nodes, "num_nodes")
    _equal(jd.y, td.y, "y")
    for field in ("node_types", "edge_src", "edge_dst", "edge_types"):
        for i, (a, b) in enumerate(zip(getattr(jd, field), getattr(td, field))):
            _equal(a, b, f"{field}[{i}]")


@pytest.mark.parametrize("split,subset", [("train", 300), ("val", None), ("test", None)])
def test_synthetic_splits_equal_jax(split, subset):
    _same_dataset(jax_load_zinc(split, subset_size=subset), load_zinc(split, subset_size=subset))


def test_npz_branch_equals_jax(tmp_path):
    """A converted split (``scripts/convert_zinc.py``'s schema) loads to the
    same arrays in both packages."""
    ds = load_zinc("val", subset_size=40)
    np.savez(tmp_path / "zinc_val.npz", num_nodes=ds.num_nodes,
             num_edges=np.array([len(s) for s in ds.edge_src]),
             node_types=np.concatenate(ds.node_types), edge_src=np.concatenate(ds.edge_src),
             edge_dst=np.concatenate(ds.edge_dst), edge_types=np.concatenate(ds.edge_types),
             y=ds.y.astype(np.float64))
    got = load_zinc("val", root=str(tmp_path), subset_size=30)
    assert not got.synthetic
    _same_dataset(jax_load_zinc("val", root=str(tmp_path), subset_size=30), got)
    _same_dataset(dataclasses.replace(ds, synthetic=False, num_nodes=ds.num_nodes[:30],
                                      node_types=ds.node_types[:30], edge_src=ds.edge_src[:30],
                                      edge_dst=ds.edge_dst[:30], edge_types=ds.edge_types[:30],
                                      y=ds.y[:30]), got)


@pytest.mark.parametrize("batch_size,n_node,n_edge,shuffle", [
    (16, 640, 1600, False),   # a full batch
    (16, 643, 1617, True),    # odd pads, shuffled
    (24, 1024, 2048, True),   # the last batch is partial (40 = 24 + 16)
])
def test_plain_collate_equals_jax_field_for_field(batch_size, n_node, n_edge, shuffle):
    jd, td = jax_load_zinc("val", subset_size=40), load_zinc("val", subset_size=40)
    kw = dict(n_node=n_node, n_edge=n_edge, shuffle=shuffle, seed=7)
    pairs = list(zip(jd.batches(batch_size, **kw), td.batches(batch_size, device="cpu", **kw)))
    assert len(pairs) == -(-40 // batch_size)
    for jb, tb in pairs:
        for f in _GRAPH_FIELDS:
            _equal(getattr(jb.graph, f), getattr(tb.graph, f), f"graph.{f}")
        for f in _BATCH_FIELDS:
            _equal(getattr(jb, f), getattr(tb, f), f)
        assert tb.n_graph == jb.n_graph and int(tb.num_graphs) == int(jb.num_graphs)
        assert tb.nodes_grouped and tb.graph.chunk_hint is None and not tb.graph.ell_exact
        # graph_ptr: the pooled readout over it is the by-graph segment sum.
        x = torch.randn(n_node, 5, generator=torch.Generator().manual_seed(0))
        torch.testing.assert_close(segment_sum_csr(x, tb.graph_ptr),
                                   segment_sum(x, tb.node_to_graph, tb.n_graph))


def test_batch_graphs_checks_its_budgets():
    kw = dict(n_graph=2, node_feats=None)
    src, dst = [np.array([0, 1])], [np.array([1, 0])]
    with pytest.raises(ValueError, match="padding node"):
        batch_graphs([4], src, dst, n_node=4, n_edge=8, device="cpu", **kw)
    with pytest.raises(ValueError, match="edges"):
        batch_graphs([4], src, dst, n_node=8, n_edge=1, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="degree-exact"):
        batch_graphs([4], src, dst, n_node=8, n_edge=8, ell_degree_budgets=(4,),
                     device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="degree-exact"):
        degree_budgets([4], src, dst, 2)


def test_degree_histogram_equals_jax():
    jd, td = jax_load_zinc("test", subset_size=500), load_zinc("test", subset_size=500)
    _equal(jd.degree_histogram(), td.degree_histogram(), "degree_histogram")
    assert td.max_nodes_edges() == jd.max_nodes_edges()


@pytest.mark.parametrize("parity", [True, False])
@pytest.mark.parametrize("hist", [[3.0, 10.0, 25.0, 8.0, 1.0], "val"])
def test_compute_avg_deg_equals_jax(parity, hist):
    if hist == "val":
        hist = load_zinc("val").degree_histogram()
    want = jax_compute_avg_deg(jnp.asarray(hist, jnp.float32), parity=parity)
    got = compute_avg_deg(hist, parity=parity)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
