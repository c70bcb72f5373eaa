"""The port's public API against the JAX package's, on the CPU.

The graph builders from neighbour lists and dense adjacencies bit for bit,
``segment_mean``, ``segment_softmax_denom`` and ``mma_mask_logits`` within
stated tolerances, the initialisers' bounds, shapes and determinism, and a
name-by-name comparison of both packages' public surfaces (parsed with
``ast``; the JAX files are read as text, not imported).
"""

import ast
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mma_tpu.graph.build import graph_from_dense as jax_graph_from_dense
from mma_tpu.graph.build import graph_from_neighbor_lists as jax_graph_from_neighbor_lists
from mma_tpu.ops.masked_aggregate import mma_mask_logits as jax_mma_mask_logits
from mma_tpu.ops.segment import segment_mean as jax_segment_mean
from mma_tpu.ops.segment import segment_softmax_denom as jax_segment_softmax_denom

import mma_tpu_torch
from mma_tpu_torch.graph import graph_from_dense, graph_from_neighbor_lists
from mma_tpu_torch.nn import Dense, Embedding
from mma_tpu_torch.nn import init as inits
from mma_tpu_torch.ops import mma_mask_logits, segment_mean, segment_softmax_denom

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARRAY_FIELDS = (
    "src", "dst", "edge_mask", "node_mask", "deg", "row_ptr",
    "src_perm", "col_ptr", "src_csc", "dst_csc",
)


def _adjacency(kind, seed=0):
    """A dense 0/1 ``adj`` (``adj[i, j]`` ⇒ edge ``j → i``) of one of three
    shapes: ``skewed`` (node 3 takes 70 of 80 sources, a 20-node run
    without in-edges), ``empty_rows`` (every third row empty, asymmetric)
    and ``no_edges``."""
    rs = np.random.RandomState(seed)
    n = 80
    if kind == "skewed":
        adj = (rs.rand(n, n) < 0.05).astype(np.float32)
        adj[3, rs.choice(n, 70, replace=False)] = 1.0
        adj[40:60] = 0.0
    elif kind == "empty_rows":
        adj = (rs.rand(n, n) < 0.15).astype(np.int32)
        adj[::3] = 0
    else:
        adj = np.zeros((n, n), np.float32)
    return adj


def _neighbor_lists(adj, seed=0):
    """``add_all[i]``: the sources of row ``i``, shuffled, so the builder's
    sort sets the order."""
    rs = np.random.RandomState(seed + 1)
    return [rs.permutation(np.nonzero(row)[0]).astype(np.int32) for row in adj]


def _assert_same_graph(got, want):
    assert (got.n_node, got.n_edge) == (want.n_node, want.n_edge)
    for name in ARRAY_FIELDS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    # The real pointers: the last (padding) node's row and column emptied.
    for name, ptr in (("real_row_ptr", want.row_ptr), ("real_col_ptr", want.col_ptr)):
        ptr = np.asarray(ptr)
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.concatenate([ptr[:-1], ptr[-2:-1]]), err_msg=name)
    assert got.chunk_hint is None


@pytest.mark.parametrize("pad", [None, (128, 2048)])
@pytest.mark.parametrize("kind", ["skewed", "empty_rows", "no_edges"])
@pytest.mark.parametrize("builder", ["neighbor_lists", "dense"])
def test_graph_builders_match_jax_bit_for_bit(builder, kind, pad):
    adj = _adjacency(kind)
    kw = {} if pad is None else dict(n_node_pad=pad[0], n_edge_pad=pad[1])
    if builder == "dense":
        got = graph_from_dense(adj, device="cpu", **kw)
        want = jax_graph_from_dense(adj, **kw)
    else:
        add_all = _neighbor_lists(adj)
        got = graph_from_neighbor_lists(add_all, device="cpu", **kw)
        want = jax_graph_from_neighbor_lists(add_all, **kw)
    _assert_same_graph(got, want)
    assert int(got.num_edges) == int(np.count_nonzero(adj))


def test_graph_builders_agree_and_take_no_nodes():
    adj = _adjacency("skewed", seed=3)
    _assert_same_graph(graph_from_dense(adj, device="cpu"),
                       jax_graph_from_neighbor_lists(_neighbor_lists(adj, seed=3)))
    _assert_same_graph(graph_from_neighbor_lists([], device="cpu"),
                       jax_graph_from_neighbor_lists([]))


def _segments(seed, n_seg=40, n_items=600, width=(8,)):
    """Sorted segment ids over ``n_seg`` segments, the even ones between 10
    and 20 empty; data ``(n_items, *width)``."""
    rs = np.random.RandomState(seed)
    pool = np.array([s for s in range(n_seg) if not (10 <= s < 20 and s % 2 == 0)])
    ids = np.sort(rs.choice(pool, n_items)).astype(np.int32)
    empty = np.setdiff1d(np.arange(n_seg), ids)
    data = (rs.randn(n_items, *width) * 3.0).astype(np.float32)
    return data, ids, empty, n_seg


def _close_rel(got, want, rel, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("width", [(8,), (), (3, 5)])
def test_segment_mean_matches_jax(width):
    data, ids, empty, n_seg = _segments(0, width=width)
    got = segment_mean(torch.from_numpy(data), torch.from_numpy(ids), n_seg).numpy()
    want = np.asarray(jax_segment_mean(jnp.asarray(data), jnp.asarray(ids), n_seg))
    assert got.shape == want.shape and len(empty) > 0
    full = np.setdiff1d(np.arange(n_seg), empty)
    _close_rel(got[full], want[full], 1e-6, "segment_mean")
    assert (got[empty] == 0).all() and (want[empty] == 0).all()


@pytest.mark.parametrize("width", [(8,), ()])
def test_segment_softmax_denom_matches_jax(width):
    data, ids, empty, n_seg = _segments(1, width=width)
    got_max, got_sum = (t.numpy() for t in segment_softmax_denom(
        torch.from_numpy(data), torch.from_numpy(ids), n_seg))
    want_max, want_sum = (np.asarray(t) for t in jax_segment_softmax_denom(
        jnp.asarray(data), jnp.asarray(ids), n_seg))
    full = np.setdiff1d(np.arange(n_seg), empty)
    _close_rel(got_max[full], want_max[full], 1e-6, "max")
    _close_rel(got_sum[full], want_sum[full], 1e-6, "sum of exp")
    # Empty segments: (0, 0) in the port; the JAX max is -inf there.
    assert (got_max[empty] == 0).all() and (got_sum[empty] == 0).all()
    assert (want_max[empty] == -np.inf).all() and (want_sum[empty] == 0).all()


@pytest.mark.parametrize("f,k", [(16, 1), (8, 3)])
def test_mma_mask_logits_matches_jax(f, k):
    adj = _adjacency("skewed", seed=f + k)
    graph = graph_from_dense(adj, device="cpu")
    jgraph = jax_graph_from_dense(adj)
    rs = np.random.RandomState(k)
    h = rs.randn(graph.n_node, f).astype(np.float32)
    mask_w = (rs.randn(k, 2 * f, f) * 0.3).astype(np.float32)
    got = mma_mask_logits(torch.from_numpy(h), torch.from_numpy(mask_w), graph).numpy()
    want = np.asarray(jax_mma_mask_logits(jnp.asarray(h), jnp.asarray(mask_w), jgraph))
    assert got.shape == want.shape == (graph.n_edge, k * f)
    _close_rel(got, want, 1e-5, "mma_mask_logits")


@pytest.mark.parametrize("shape", [(64, 16), (7, 3, 5), (300,)])
def test_initialisers_bounds_shapes_and_determinism(shape):
    def draw(fn, seed):
        return fn(shape, torch.Generator().manual_seed(seed))

    u = draw(inits.uniform_fan_in, 0)
    assert u.shape == shape and u.dtype == torch.float32
    bound = 1.0 / np.sqrt(shape[0])
    assert u.abs().max() <= bound and u.abs().max() > 0.5 * bound
    n = draw(inits.normal, 0)
    assert n.shape == shape and n.dtype == torch.float32
    assert abs(float(n.mean())) < 0.3 and 0.7 < float(n.std()) < 1.3
    for fn in (inits.uniform_fan_in, inits.normal):
        assert torch.equal(draw(fn, 5), draw(fn, 5))
        assert not torch.equal(draw(fn, 5), draw(fn, 6))


def test_dense_and_embedding_draw_from_the_initialisers():
    dense = Dense(12, 5, device="cpu", generator=torch.Generator().manual_seed(2))
    assert torch.equal(dense.w.detach(),
                       inits.uniform_fan_in((12, 5), torch.Generator().manual_seed(2)))
    emb = Embedding(9, 4, device="cpu", generator=torch.Generator().manual_seed(3))
    assert torch.equal(emb.table.detach(), inits.normal((9, 4), torch.Generator().manual_seed(3)))


# ---- the public surfaces, name by name ---------------------------------

# Names of the JAX package with no counterpart, each with its reason.
TPU_ONLY = {
    "chunk_hint_from_row_ptr": "bounds the TPU kernels' grid; the port's kernels take their "
                               "partition from shapes and Graph.chunk_hint stays None",
    "shape_canonical_chunk_hint": "the same grid bound for device-built graphs",
    "batch_shard_spec": "a jax.sharding spec; the port's ranks each hold their own piece",
    "BLOCK_B": "a TPU tile size (edges a block)",
    "BLOCK_R": "a TPU tile size (rows a block)",
    "BLOCK_SUB": "a TPU tile size (sublanes)",
    "VMEM_BUDGET_MB": "the TPU's VMEM budget for the tiles",
    "choose_blocks": "picks the TPU tiles; the port's kernels take no block sizes",
}

# Names whose counterpart lives under another name or in another module:
# JAX name -> (port module, port name, why).
RENAMED = {
    "fused_segment_sum": ("ops/cuda/fused_mma.py", "segment_sum_csr",
                          "kernel 1 takes the CSR, not the Graph"),
    "fused_segment_sum_raw": ("ops/cuda/fused_mma.py", "segment_sum_csr",
                              "kernel 1 over raw CSR arrays, as every call of it"),
    "fused_segment_sum_by_src": ("ops/cuda/fused_mma.py", "segment_sum_csr",
                                 "kernel 1 over the CSC with index=src_perm"),
    "fused_segment_sum_csc": ("ops/cuda/fused_mma.py", "segment_sum_csr",
                              "kernel 1 over the CSC on CSC-ordered rows"),
    "fused_segment_sum_sq": ("ops/cuda/fused_mma.py", "segment_sum_sq_csr",
                             "kernel 8 takes the CSR"),
    "fused_mma_edge_program": ("ops/cuda/fused_mma.py", "edge_program",
                               "kernels 9-11 take the CSR and CSC arrays"),
    "fused_mma_edge_program_lean": ("ops/cuda/fused_mma.py", "edge_program_lean",
                                    "kernels 2-3 take the CSR and CSC arrays"),
    "set_learning_rate": ("train/loops.py", "set_learning_rate",
                          "sets torch.optim's param groups, beside the loops that call it"),
}


def _port_path(rel):
    return rel.replace("ops/pallas/", "ops/cuda/")


def _surface(path):
    """``(defined, imported, exports)``: the module's public top-level
    definitions, the names it imports, and its ``__all__`` (or, for a
    package ``__init__`` without one, its imported public names)."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    defined, imported, all_ = set(), set(), None
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            defined.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    defined.add(t.id)
                    if t.id == "__all__":
                        all_ = [e.value for e in node.value.elts]
        elif isinstance(node, ast.ImportFrom):
            imported.update(a.asname or a.name for a in node.names)
    public = {n for n in defined if not n.startswith("_")}
    if all_ is None and os.path.basename(path) == "__init__.py":
        all_ = sorted(n for n in imported if not n.startswith("_"))
    return public, imported, all_ or []


def _modules(pkg):
    base = os.path.join(ROOT, pkg)
    for dirpath, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                yield os.path.relpath(path, base).replace(os.sep, "/"), path


def test_every_public_jax_name_has_a_counterpart():
    port_root = os.path.join(ROOT, "mma_tpu_torch")
    missing = []
    for rel, path in sorted(_modules("mma_tpu")):
        port = os.path.join(port_root, _port_path(rel))
        if not os.path.exists(port):
            missing.append(f"{rel}: no module {_port_path(rel)}")
            continue
        public, _, exports = _surface(path)
        p_public, p_imported, p_exports = _surface(port)
        for name in sorted(public):
            if name in p_public or name in p_imported or name in TPU_ONLY:
                continue
            if name in RENAMED:
                where, alias, _ = RENAMED[name]
                if alias in _surface(os.path.join(port_root, where))[0]:
                    continue
            missing.append(f"{rel}: {name}")
        missing += [f"{rel}: __all__ entry {n}" for n in exports if n not in p_exports]
    assert not missing, missing
    # The allow-lists name nothing the JAX package lacks.
    jax_names = set()
    for _, path in _modules("mma_tpu"):
        jax_names |= _surface(path)[0]
    assert set(TPU_ONLY) | set(RENAMED) <= jax_names


def test_top_level_exports_resolve_without_jax_names():
    for name in mma_tpu_torch.__all__:
        assert getattr(mma_tpu_torch, name) is not None, name
    for name in ("graph_from_dense", "graph_from_neighbor_lists", "ZincNet",
                 "MultiMaskConv", "BatchedGraphs"):
        assert name in mma_tpu_torch.__all__, name
